"""The port's per-leaf fold of block digests against the JAX reference, on the CPU.

``block_hash_fold_ref`` is the plain version that the fused CUDA kernel
(``block_hash_fold_kernel``: hash every row and fold it into its leaf's
lanes in one launch) is held against on the card.  Here it is held bit for
bit against the reference's ``_batched_lanes`` (the hash, then XLA's
``segment_sum``), run on its XLA path and with its Pallas kernel in
interpret mode, on seeded ragged manifests: empty leaves, one large leaf,
many one-row leaves, u32 grids and u8 grids (the reference widens bytes to
u32; the port hashes the bytes as they are).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_delta import ops as J  # noqa: E402
from repro_torch.kernels.hash_delta import kernel as TK  # noqa: E402
from repro_torch.kernels.hash_delta import ops as T  # noqa: E402
from repro_torch.kernels.hash_delta.ref import block_hash_fold_ref  # noqa: E402

CPU = torch.device("cpu")

# leaf sizes in rows; the XLA path takes the large ones, interpret mode
# (one grid step a row) the small ones
MANIFESTS = {
    "empty_between": [3, 0, 4],
    "empty_at_the_ends": [0, 5, 0, 0, 2, 0],
    "one_large_leaf": [700],
    "many_one_row_leaves": [1] * 300,
    "ragged": [1, 17, 0, 64, 2, 0, 0, 129, 5],
}
SMALL = {
    "empty_between": [3, 0, 4],
    "one_leaf": [12],
    "one_row_leaves": [1] * 9,
}


def _grid(rng, nb: int, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, (nb, T.BLOCK), dtype=np.uint8)
    return rng.integers(0, 2**32, (nb, T.BLOCK), dtype=np.uint32)


def _port_fold(x: np.ndarray, nbs) -> np.ndarray:
    nb = x.shape[0]
    fw = torch.from_numpy(T._fold_weights(nbs))
    xt = torch.from_numpy(x if x.dtype == np.uint8 else x.view(np.int32))
    lanes = block_hash_fold_ref(xt, T.weights(CPU), fw[0, :nb], fw[1, :nb],
                                len(nbs))
    assert lanes.dtype == torch.int32 and tuple(lanes.shape) == (len(nbs), 2)
    return lanes.numpy().view(np.uint32)


def _reference_fold(x: np.ndarray, nbs, **impl) -> np.ndarray:
    idx, seg = J._fold_weights(nbs)
    return np.asarray(J._batched_lanes(
        jnp.asarray(x.astype(np.uint32)), jnp.asarray(idx), jnp.asarray(seg),
        num_leaves=len(nbs), **impl))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint8],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(MANIFESTS))
def test_plain_fold_matches_reference_xla(name, dtype):
    nbs = MANIFESTS[name]
    rng = np.random.default_rng(len(name) * 7 + np.dtype(dtype).itemsize)
    x = _grid(rng, sum(nbs), dtype)
    np.testing.assert_array_equal(_port_fold(x, nbs),
                                  _reference_fold(x, nbs, impl="xla"))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint8],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(SMALL))
def test_plain_fold_matches_reference_pallas_interpret(name, dtype):
    nbs = SMALL[name]
    rng = np.random.default_rng(len(name) + np.dtype(dtype).itemsize)
    x = _grid(rng, sum(nbs), dtype)
    np.testing.assert_array_equal(
        _port_fold(x, nbs),
        _reference_fold(x, nbs, impl="pallas", interpret=True))


@pytest.mark.parametrize("name", list(MANIFESTS))
def test_fold_weights_match_reference(name):
    nbs = MANIFESTS[name]
    nb = sum(nbs)
    fw = T._fold_weights(nbs)
    idx, seg = J._fold_weights(nbs)
    assert fw.dtype == np.int32 and fw.shape == (2, -(-nb // 4) * 4)
    np.testing.assert_array_equal(fw[0, :nb].view(np.uint32), idx)
    np.testing.assert_array_equal(fw[1, :nb], seg)
    assert not fw[:, nb:].any()


def test_cpu_digest_leaves_reaches_the_plain_fold(monkeypatch):
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return block_hash_fold_ref(*args)

    monkeypatch.setattr(T, "block_hash_fold_ref", counting)
    rng = np.random.default_rng(21)
    leaves = [rng.standard_normal(n).astype(np.float32)
              for n in (5000, 0, 1024, 3)]
    want = J.digest_leaves(leaves, impl="xla")
    assert T.digest_leaves(leaves, device=CPU) == want
    assert calls == [(5 + 1 + 1, T.BLOCK)]
    prior = list(want)
    prior[2] ^= 1
    assert T.digest_leaves_delta(leaves, prior, device=CPU) == (want, [2])
    assert len(calls) == 2


def test_fold_wrapper_rejects_what_the_kernel_does_not_take():
    w = T.weights(CPU)
    x = torch.zeros((3, T.BLOCK), dtype=torch.int32)
    idx = torch.ones(3, dtype=torch.int32)
    seg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.block_hash_fold_kernel(x, w, idx, seg, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.block_hash_fold_kernel(x.to(torch.uint8), w, idx, seg, 1)
    with pytest.raises(TypeError, match="idx: dtype"):
        TK.block_hash_fold_kernel(x, w, idx.to(torch.int64), seg, 1)
    with pytest.raises(TypeError, match="seg: dtype"):
        TK.block_hash_fold_kernel(x, w, idx, seg.to(torch.int64), 1)
    with pytest.raises(ValueError, match="idx: shape"):
        TK.block_hash_fold_kernel(x, w, idx[:2], seg, 1)
    with pytest.raises(ValueError, match="seg: shape"):
        TK.block_hash_fold_kernel(x, w, idx, seg[:, None], 1)
    with pytest.raises(ValueError, match="1024"):
        TK.block_hash_fold_kernel(torch.zeros((3, 512), dtype=torch.int32),
                                  w, idx, seg, 1)
