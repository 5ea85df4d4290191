"""The port's checkpointing against the JAX reference's, on the CPU.

Every case of ``tests/test_checkpoint.py`` runs on both packages (the
reference with jax arrays, the port with torch tensors and
``device="cpu"``); a checkpoint that one package saves, the other restores,
with JSON-equal manifests and the same chunk files; equal
``CheckpointInfo`` (apart from seconds) for one save sequence; the storage
keys against ``jax.tree_util.keystr``.  Restored values are compared bit
for bit: checkpointing is lossless (codec ``zstd`` or ``none``), so there
is no tolerance.
"""
import collections
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import AsyncCheckpointer as RefAsync  # noqa: E402
from repro.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer, Checkpointer  # noqa: E402
from repro_torch.core.reducer import (  # noqa: E402
    tree_flatten_with_path, tree_map_with_path,
)

PACKAGES = ["ref", "port"]
Step = collections.namedtuple("Step", "step lr")


def make(pkg, directory, **kw):
    if pkg == "ref":
        return RefCheckpointer(str(directory), **kw)
    return Checkpointer(str(directory), device="cpu", **kw)


def make_async(pkg, inner):
    return (RefAsync if pkg == "ref" else AsyncCheckpointer)(inner)


def arr(pkg, a):
    """A numpy array as the package's own array type."""
    return jnp.asarray(a) if pkg == "ref" else torch.from_numpy(np.array(a))


def _tree(pkg, x=0.0):
    return {"params": {"w": arr(pkg, np.arange(100, dtype=np.float32) + x),
                       "frozen": arr(pkg, np.ones((50,), np.float32))},
            "meta": {"step": np.int64(3)}}


def host(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


# ----------------------------------------------------------------------
# every case of tests/test_checkpoint.py, on both packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_roundtrip(tmp_path, pkg):
    ck = make(pkg, tmp_path)
    t = _tree(pkg)
    ck.save(1, {"state": t})
    out, step = ck.restore({"state": t})
    assert step == 1
    np.testing.assert_array_equal(host(out["state"]["params"]["w"]),
                                  host(t["params"]["w"]))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_delta_skips_unchanged_leaves(tmp_path, pkg):
    ck = make(pkg, tmp_path)
    i1 = ck.save(1, {"state": _tree(pkg, 0.0)})
    assert i1.n_leaves_written == i1.n_leaves_total
    i2 = ck.save(2, {"state": _tree(pkg, 1.0)})   # only "w" changed
    assert i2.n_leaves_written < i2.n_leaves_total
    out, step = ck.restore({"state": _tree(pkg)})
    assert step == 2
    np.testing.assert_array_equal(host(out["state"]["params"]["w"]),
                                  np.arange(100, dtype=np.float32) + 1.0)
    np.testing.assert_array_equal(host(out["state"]["params"]["frozen"]),
                                  np.ones(50, np.float32))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restore_specific_step(tmp_path, pkg):
    ck = make(pkg, tmp_path)
    ck.save(1, {"state": _tree(pkg, 0.0)})
    ck.save(2, {"state": _tree(pkg, 5.0)})
    out, step = ck.restore({"state": _tree(pkg)}, step=1)
    assert step == 1
    np.testing.assert_array_equal(host(out["state"]["params"]["w"]),
                                  np.arange(100, dtype=np.float32))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_corruption_detected(tmp_path, pkg):
    ck = make(pkg, tmp_path)
    ck.save(1, {"state": _tree(pkg)})
    blob = sorted(f for f in os.listdir(tmp_path) if f.endswith(".bin"))[0]
    p = os.path.join(tmp_path, blob)
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        ck.restore({"state": _tree(pkg)})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_async_checkpointer(tmp_path, pkg):
    ck = make_async(pkg, make(pkg, tmp_path))
    ck.save(1, {"state": _tree(pkg)})
    ck.wait()
    assert ck.last_info is not None and ck.last_info.step == 1
    out, step = ck.inner.restore({"state": _tree(pkg)})
    assert step == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gc_rebase_chain(tmp_path, pkg):
    ck = make(pkg, tmp_path, keep=2, rebase_every=5)
    for s in range(1, 7):
        ck.save(s, {"state": _tree(pkg, float(s))})
    steps = ck._steps()
    # save #6 is a FULL rebase -> everything older is GC-safe to drop
    assert steps[-1] == 6
    assert ck._manifest(6)["full"]
    out, step = ck.restore({"state": _tree(pkg)})
    assert step == 6
    np.testing.assert_array_equal(host(out["state"]["params"]["w"]),
                                  np.arange(100, dtype=np.float32) + 6.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tombstone_through_storage_checkpoint_cycle(tmp_path, pkg):
    """A leaf dropped between saves is a tombstone on the storage env: the
    next manifest records it deleted, the storage namespace drops it, and a
    restore of the later step never resurrects it."""
    ck = make(pkg, tmp_path)
    a = lambda x: arr(pkg, x)  # noqa: E731
    ck.save(1, {"state": {"a": a(np.arange(10.0)), "b": a(np.ones(5))}})
    info = ck.save(2, {"state": {"a": a(np.arange(10.0) + 1.0)}})
    assert info.n_leaves_total == 1
    m2 = ck._manifest(2)
    dead = [n for n in m2["deleted"] if n.startswith("state/")]
    assert len(dead) == 1                      # the vanished "b" leaf
    assert dead[0] not in m2["names"] and dead[0] not in m2["digests"]
    assert dead[0] not in ck.storage.state.ns
    assert not ck.storage.state.ns
    out, step = ck.restore({"state": {"a": a(np.arange(10.0))}})
    assert step == 2
    np.testing.assert_array_equal(host(out["state"]["a"]),
                                  np.arange(10.0) + 1.0)
    out1, step1 = ck.restore({"state": {"a": a(np.arange(10.0)),
                                        "b": a(np.ones(5))}}, step=1)
    assert step1 == 1
    np.testing.assert_array_equal(host(out1["state"]["b"]), np.ones(5))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_checkpoint_chunk_delta_reships_only_changed_chunks(tmp_path, pkg):
    """A 1-element update to a large leaf writes ~one chunk, not the leaf."""
    ck = make(pkg, tmp_path, codec="zstd", chunk_bytes=16 << 10)
    big = np.arange(1 << 18, dtype=np.float32)          # 1 MiB, 64 chunks
    i1 = ck.save(1, {"state": {"big": arr(pkg, big)}})
    big2 = big.copy()
    big2[3] += 1.0
    i2 = ck.save(2, {"state": {"big": arr(pkg, big2)}})
    assert i2.n_leaves_written == 1                     # leaf digest changed
    assert i2.nbytes < i1.nbytes / 10                   # but ~1 chunk moved
    out, step = ck.restore({"state": {"big": arr(pkg, big)}})
    assert step == 2
    np.testing.assert_array_equal(host(out["state"]["big"]), big2)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restart_mid_chain(tmp_path, pkg):
    ck = make(pkg, tmp_path, rebase_every=10)
    for s in range(1, 5):
        ck.save(s, {"state": _tree(pkg, float(s))})
    ck2 = make(pkg, tmp_path, rebase_every=10)   # a fresh process
    out, step = ck2.restore({"state": _tree(pkg)})
    assert step == 4
    np.testing.assert_array_equal(host(out["state"]["params"]["w"]),
                                  np.arange(100, dtype=np.float32) + 4.0)


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------

def _rich(pkg, x=0.0):
    """Every node type the storage keys name, bf16/int64/0-d leaves and a
    leaf of several chunks."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal(300_000).astype(np.float32)
    big[7] += x
    bf = rng.standard_normal((3, 70)).astype(np.float32)
    return {
        "params": {"w": arr(pkg, big),
                   "bf": (jnp.asarray(bf, jnp.bfloat16) if pkg == "ref"
                          else torch.from_numpy(bf).bfloat16()),
                   # numpy in both packages: jax arrays are 32-bit here
                   "layers": [np.arange(6, dtype=np.int64),
                              (arr(pkg, np.ones((2, 2), np.float32) * x),
                               None)]},
        "by_id": {3: arr(pkg, np.arange(4, dtype=np.int32)),
                  1: arr(pkg, np.full(2, x, np.float32))},
        "opt": Step(arr(pkg, np.float32(x)), np.float64(1e-3)),
        "order": collections.OrderedDict([
            ("z", arr(pkg, np.zeros(3, np.float32))),
            ("a", arr(pkg, np.ones(2, np.float32)))]),
        "data_step": np.int64(17 + int(x)),
    }


def _save_sequence(pkg, directory):
    ck = make(pkg, directory, chunk_bytes=64 << 10)
    infos = [ck.save(s, {k: v for k, v in _rich(pkg, float(s)).items()})
             for s in (1, 2)]
    infos.append(ck.save(3, {"params": _rich(pkg, 2.0)["params"]}))
    return ck, infos


def _equal_trees(got, want):
    g = tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            a = a.view(torch.int16).numpy()
            b = np.asarray(b).view(np.int16)
        np.testing.assert_array_equal(host(a), np.asarray(b), err_msg=path)


def test_manifests_chunks_and_infos_equal_across_packages(tmp_path):
    """One save sequence (two full trees, then a subset: tombstones) in
    each package: equal ``CheckpointInfo`` apart from seconds, JSON-equal
    manifests, the same chunk files byte for byte."""
    ref, ref_infos = _save_sequence("ref", tmp_path / "ref")
    port, port_infos = _save_sequence("port", tmp_path / "port")
    for a, b in zip(port_infos, ref_infos):
        assert (a.step, a.nbytes, a.n_leaves_written, a.n_leaves_total) == \
            (b.step, b.nbytes, b.n_leaves_written, b.n_leaves_total)
    assert port_infos[1].n_leaves_written < port_infos[1].n_leaves_total
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))
    for fn in os.listdir(tmp_path / "ref"):
        a = (tmp_path / "port" / fn).read_bytes()
        b = (tmp_path / "ref" / fn).read_bytes()
        if fn.endswith(".json"):
            assert json.loads(a) == json.loads(b), fn
        else:
            assert a == b, fn


@pytest.mark.parametrize("saver,restorer", [("ref", "port"), ("port", "ref")])
def test_one_package_restores_what_the_other_saved(tmp_path, saver, restorer):
    _save_sequence(saver, tmp_path)
    ck = make(restorer, tmp_path)
    for step in (1, 2):
        out, got_step = ck.restore(_rich(restorer), step=step)
        assert got_step == step
        _equal_trees(out if restorer == "port" else
                     tree_map_with_path(lambda _p, x: x, out),
                     _rich("ref", float(step)))
    out, _ = ck.restore({"params": _rich(restorer)["params"]})
    _equal_trees(out, {"params": _rich("ref", 2.0)["params"]})


def test_restored_leaves_follow_their_templates(tmp_path):
    """A tensor template leaf gets a tensor in its dtype (bf16 with the
    saved bits; an f32 template the bf16 values widened); a numpy template
    leaf gets numpy, as the reference returns it."""
    ck = make("port", tmp_path)
    bf = torch.randn(4, 5, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    ck.save(1, {"s": {"bf": bf, "n": np.arange(3.0)}})
    out, _ = ck.restore({"s": {"bf": torch.zeros(4, 5, dtype=torch.bfloat16),
                               "n": np.zeros(3)}})
    assert out["s"]["bf"].dtype == torch.bfloat16
    assert torch.equal(out["s"]["bf"].view(torch.int16), bf.view(torch.int16))
    assert isinstance(out["s"]["n"], np.ndarray)
    out, _ = ck.restore({"s": {"bf": torch.zeros(4, 5), "n": np.zeros(3)}})
    assert out["s"]["bf"].dtype == torch.float32
    assert torch.equal(out["s"]["bf"], bf.float())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_digest_mismatch_raises(tmp_path, pkg):
    ck = make(pkg, tmp_path)
    ck.save(1, {"state": _tree(pkg)})
    path = ck._manifest_path(1)
    m = json.load(open(path))
    name = "state/['params']['w']"
    m["digests"][name] ^= 1
    json.dump(m, open(path, "w"))
    with pytest.raises(IOError, match="digest mismatch"):
        ck.restore({"state": _tree(pkg)})


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": {"x": 2, "y": 3}},
    {2: "two", 1: "one"},
    [1, (2, 3), [4]],
    (5,),
    Step(step=1, lr=2),
    collections.OrderedDict([("z", 1), ("y", 2)]),
    collections.defaultdict(list, {"q": 5, "p": 6}),
    {"none": None, "leaf": 1, "nested": [None, {"k": None, "v": 2}]},
    7,
], ids=["dict", "int-keys", "list-tuple", "one-tuple", "namedtuple",
        "ordereddict", "defaultdict", "none", "root-leaf"])
def test_storage_keys_are_jax_keystr_paths(tree):
    want = [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tree_flatten_with_path(tree) == want
    rebuilt = tree_map_with_path(lambda _p, x: x, tree)
    ref_rebuilt = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), jax.tree_util.tree_leaves(tree))
    assert type(rebuilt) is type(ref_rebuilt) and rebuilt == ref_rebuilt
    if isinstance(tree, dict):
        assert list(rebuilt) == list(ref_rebuilt)
    if isinstance(tree, collections.defaultdict):
        assert rebuilt.default_factory is tree.default_factory


def test_root_leaf_key_is_the_name_alone(tmp_path):
    """A leaf at a tree's root stores under ``name/`` (keystr ``''``), in
    both packages."""
    for pkg in PACKAGES:
        ck = make(pkg, tmp_path / pkg)
        ck.save(1, {"data_step": np.int64(5)})
        assert list(ck._manifest(1)["names"]) == ["data_step/"]
        out, _ = ck.restore({"data_step": np.int64(0)})
        assert int(out["data_step"]) == 5


def test_async_save_snapshots_before_it_returns(tmp_path):
    """An in-place change right after ``save`` returns is not in the
    checkpoint; an error in the writer is raised by ``wait``."""
    ck = AsyncCheckpointer(make("port", tmp_path))
    w = torch.arange(1000, dtype=torch.float32)
    ck.save(1, {"s": {"w": w}})
    w += 1.0
    ck.wait()
    out, _ = ck.inner.restore({"s": {"w": torch.zeros(1000)}})
    assert torch.equal(out["s"]["w"], torch.arange(1000, dtype=torch.float32))
    ck.save(2, {"s": {"w": object()}})
    with pytest.raises(Exception):
        ck.wait()
    ck.wait()                                  # the error is raised once


def _no_cuda(*_a, **_k):
    raise AssertionError("a device='cpu' checkpoint asked for CUDA")


def test_a_cpu_checkpoint_never_touches_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", _no_cuda)
    ck = AsyncCheckpointer(make("port", tmp_path))
    ck.save(1, _rich("port"))
    ck.wait()
    out, step = ck.inner.restore(_rich("port"))
    assert step == 1
    _equal_trees(out, _rich("ref"))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Checkpointer(str(tmp_path))


JAX_FREE = """
import sys, tempfile
import numpy as np, torch
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import LM, encdec, frontends, moe
from repro_torch.configs import get_config
d = tempfile.mkdtemp()
ck = Checkpointer(d, device="cpu")
lm = LM(get_config("qwen3-moe-235b-a22b", reduced=True), device="cpu")
ck.save(1, {"params": lm.init(0, torch.float32)})
out, step = ck.restore({"params": lm.params})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not bad, bad
print("ok", step)
"""


def test_checkpoint_and_the_new_families_run_without_jax():
    """The checkpoint package and the moe, encdec and vlm modules import
    and run with only the port on the path: no jax, no reference."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": os.path.join(root, "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", JAX_FREE], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok 1")
