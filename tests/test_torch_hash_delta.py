"""The PyTorch port's hash_delta against the JAX reference, on the CPU.

Digests and chunk keys are content addresses shared by both packages, so
every comparison here is bit for bit.  Inputs come from numpy seeds and go
through both packages; the reference runs its XLA path, and its Pallas
kernels in interpret mode at one small size.  The port's CPU path is the
plain PyTorch version that the CUDA kernels are held against on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_delta import ops as J  # noqa: E402
from repro_torch.kernels.hash_delta import kernel as TK  # noqa: E402
from repro_torch.kernels.hash_delta import ops as T  # noqa: E402

CPU = torch.device("cpu")
DTYPES = (np.float32, np.float16, np.float64, np.int8, np.uint8, np.int16,
          np.int32, np.uint32, np.int64, np.bool_)
SIZES = (0, 1, 1023, 1024, 1025)


def _arr(rng, dtype, n):
    a = rng.standard_normal(n) * 1e3
    if dtype == np.bool_:
        return a > 0
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    return a.astype(dtype)


def _u32(lanes) -> np.ndarray:
    return np.asarray(lanes).view(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_tensor_digest_matches_reference_per_dtype_and_size(dtype):
    rng = np.random.default_rng(1)
    for n in SIZES:
        a = _arr(rng, dtype, n)
        want = J.tensor_digest(a, impl="xla")
        assert T.tensor_digest(torch.from_numpy(a)) == want, (dtype, n)
        assert T.digest_leaves([a], device=CPU) == [want], (dtype, n)
        assert T.digest_leaves([torch.from_numpy(a)], device=CPU) == [want]


def test_bf16_digest_matches_reference():
    x = np.random.default_rng(2).standard_normal((37, 55)).astype(np.float32)
    want = J.tensor_digest(jnp.asarray(x).astype(jnp.bfloat16), impl="xla")
    assert T.tensor_digest(torch.from_numpy(x).to(torch.bfloat16)) == want


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_block_digest_lanes_bit_identical(n):
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = _u32(J.block_digests(a, impl="xla"))
    got = T.block_digests(torch.from_numpy(a)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_block_digests_compare_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(7 * 1024 - 5).astype(np.float32)
    lanes = _u32(J.block_digests(a, impl="xla")).copy()
    lanes[2, 1] ^= 1
    has = np.ones((7, 1), np.uint32)
    has[5] = 0
    hj, cj = J.block_digests_compare(a, jnp.asarray(lanes), jnp.asarray(has),
                                     impl="xla")
    ht, ct = T.block_digests_compare(torch.from_numpy(a),
                                     torch.from_numpy(lanes.view(np.int32)),
                                     torch.from_numpy(has.view(np.int32)))
    np.testing.assert_array_equal(ht.numpy().view(np.uint32), _u32(hj))
    np.testing.assert_array_equal(ct.numpy().view(np.uint32), _u32(cj))
    assert list(ct[:, 0]) == [0, 0, 1, 0, 0, 1, 0]


@pytest.mark.parametrize("seed", range(4))
def test_ragged_batches_bit_identical(seed):
    rng = np.random.default_rng(seed)
    leaves = [_arr(rng, DTYPES[int(k) % len(DTYPES)], int(n))
              for k, n in zip(rng.integers(0, 100, 12),
                              rng.integers(0, 3000, 12))]
    # every third leaf travels as a torch tensor: mixed host packing
    mixed = [torch.from_numpy(a) if i % 3 == 1 else a
             for i, a in enumerate(leaves)]
    want = J.digest_leaves(leaves, impl="xla")
    assert T.digest_leaves(mixed, device=CPU) == want
    priors = list(want)
    priors[0] = None
    priors[1] = (priors[1] or 0) ^ 1
    assert (T.digest_leaves_delta(mixed, priors, device=CPU)
            == J.digest_leaves_delta(leaves, priors, impl="xla"))


def test_all_empty_and_no_leaves():
    empty = [np.zeros(0, np.float32), np.zeros((0, 3), np.int8)]
    assert T.digest_leaves(empty, device=CPU) == J.digest_leaves(empty,
                                                                 impl="xla")
    assert T.digest_leaves([], device=CPU) == []
    assert (T.digest_leaves_delta(empty, [None, 0], device=CPU)
            == J.digest_leaves_delta(empty, [None, 0], impl="xla"))
    assert T.digest_leaves_delta([], [], device=CPU) == ([], [])


def test_delta_reports_exactly_the_changed_leaves():
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(300).astype(np.float32) for _ in range(9)]
    prior = T.digest_leaves(leaves, device=CPU)
    mutated = [a.copy() for a in leaves]
    mutated[2][7] += 1.0
    mutated[6][0] -= 0.5
    priors = list(prior)
    priors[4] = None
    digests, changed = T.digest_leaves_delta(mutated, priors, device=CPU)
    assert changed == [2, 4, 6]
    assert digests == J.digest_leaves(mutated, impl="xla")


@pytest.mark.parametrize("nbytes", [1024, 5 * 1024, 64 * 1024])
def test_packed_byte_grid_matches_reference(nbytes):
    rng = np.random.default_rng(nbytes)
    u8 = rng.integers(0, 256, nbytes, dtype=np.uint8)
    want = _u32(J.packed_block_digests(jnp.asarray(u8), impl="xla"))
    got = T.packed_block_digests(torch.from_numpy(u8))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    nb = nbytes // 1024
    prior = want.copy()
    prior[nb // 2, 0] += np.uint32(1)
    has = np.ones((nb, 1), np.uint32)
    hj, cj = J.packed_block_digests_compare(
        jnp.asarray(u8), jnp.asarray(prior), jnp.asarray(has), impl="xla")
    ht, ct = T.packed_block_digests_compare(
        torch.from_numpy(u8), torch.from_numpy(prior.view(np.int32)),
        torch.from_numpy(has.view(np.int32)))
    np.testing.assert_array_equal(ht.numpy().view(np.uint32), _u32(hj))
    np.testing.assert_array_equal(ct.numpy().view(np.uint32), _u32(cj))


def test_matches_reference_pallas_kernels_in_interpret_mode():
    from repro.kernels.hash_delta.kernel import (
        block_hash_compare_kernel, block_hash_kernel,
    )
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, (6, T.BLOCK), dtype=np.uint32)
    w = jnp.asarray(J._W)
    hk = _u32(block_hash_kernel(jnp.asarray(x), w, interpret=True))
    xt = torch.from_numpy(x.view(np.int32))
    np.testing.assert_array_equal(
        T._lanes(xt).numpy().view(np.uint32), hk)
    prior = hk.copy()
    prior[3, 0] += np.uint32(1)
    has = np.ones((6, 1), np.uint32)
    has[5, 0] = 0
    hj, cj = block_hash_compare_kernel(jnp.asarray(x), w, jnp.asarray(prior),
                                       jnp.asarray(has), interpret=True)
    ht, ct = T._lanes_compare(xt, torch.from_numpy(prior.view(np.int32)),
                              torch.from_numpy(has.view(np.int32)))
    np.testing.assert_array_equal(ht.numpy().view(np.uint32), _u32(hj))
    np.testing.assert_array_equal(ct.numpy().view(np.uint32), _u32(cj))


def test_weights_are_the_reference_weights():
    np.testing.assert_array_equal(T._W, J._W)
    assert (T.BLOCK, T.LANES, T._FOLD) == (J.BLOCK, J.LANES, int(J._FOLD))


def test_one_host_sync_per_batched_call():
    rng = np.random.default_rng(13)
    leaves = [rng.standard_normal(256).astype(np.float32) for _ in range(40)]
    T.reset_host_syncs()
    for a in leaves:
        T.tensor_digest(torch.from_numpy(a))
    assert T.HOST_SYNCS == 40
    T.reset_host_syncs()
    T.digest_leaves(leaves, device=CPU)
    assert T.HOST_SYNCS == 1
    T.reset_host_syncs()
    T.digest_leaves_delta(leaves, [None] * 40, device=CPU)
    assert T.HOST_SYNCS == 1


def test_staging_reuse_cannot_corrupt_consecutive_calls():
    rng = np.random.default_rng(17)
    first = [rng.standard_normal(n).astype(np.float32) for n in (900, 3000)]
    second = [rng.standard_normal(n).astype(np.float32) for n in (2000, 10)]
    want = J.digest_leaves(first, impl="xla")
    got1 = T.digest_leaves(first, device=CPU)
    T.digest_leaves(second, device=CPU)
    assert got1 == want == T.digest_leaves(first, device=CPU)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    w = T.weights(CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.block_hash_kernel(torch.zeros((2, 1024), dtype=torch.int32), w)
    with pytest.raises(ValueError, match="1024"):
        TK.block_hash_kernel(torch.zeros((2, 512), dtype=torch.int32), w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.block_hash_compare_kernel(
            torch.zeros((2, 1024), dtype=torch.uint8), w,
            torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32))
