"""The PyTorch port's StateReducer against the JAX reference, on the CPU.

On the same namespaces both reducers must give the same digests, deltas and
serialized output (digests, chunk keys, encoded chunks, array metas, pickle
bytes, ``nbytes``), and each must read what the other writes.  Torch tensors
stand where the reference holds jax arrays: 32-bit and narrower tensors
against equal jax arrays, 64-bit and complex tensors against equal numpy
arrays (jax holds no 64-bit arrays with x64 off).
"""
import dataclasses
from collections import OrderedDict, defaultdict, namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.chunkstore import DiskChunkStore as RefDisk  # noqa: E402
from repro.core.reducer import StateReducer as RefReducer  # noqa: E402
from repro.core.state import ExecutionState as RefState  # noqa: E402
from repro_torch.core.chunkstore import DiskChunkStore  # noqa: E402
from repro_torch.core.reducer import StateReducer, _tree_flatten  # noqa: E402
from repro_torch.core.state import ExecutionState  # noqa: E402

CODECS = ("none", "zlib", "quant8+zstd")
CHUNK = 8192      # small chunks: several per array at test sizes


def _host_ns(seed: int = 0) -> dict:
    """A namespace of host objects both packages hold as they are."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(3000).astype(np.float32)
    return {
        "f32": a,
        "f16": rng.standard_normal(777).astype(np.float16),
        "f64": rng.standard_normal(2049),
        "i64": rng.integers(-2**62, 2**62, 1500),
        "u8": rng.integers(0, 256, (40, 40), dtype=np.uint8),
        "i8": rng.integers(-128, 128, 999, dtype=np.int8),
        "flags": rng.standard_normal(333) > 0,
        "c128": rng.standard_normal(300) + 1j * rng.standard_normal(300),
        "tree": {"b": a[:10], "a": [a[:5], (a[5:9].astype(np.int32),)],
                 "c": None},
        "pair": (a, a),                     # one chunk set, two references
        "mixed": [a[:4], 3, "s"],           # not a pure array tree
        "empty": np.zeros((0, 3), np.float32),
        "big": rng.standard_normal(50_000).astype(np.float32),
        "scalar": 3.5,
        "text": "hello",
        "cfg": {"lr": 1e-3, "layers": [1, 2]},
    }


def _device_pairs(seed: int = 1) -> tuple[dict, dict]:
    """(reference namespace, port namespace) holding equal device arrays."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((64, 50)).astype(np.float32)
    i = rng.integers(-2**31, 2**31 - 1, 2000).astype(np.int32)
    u = rng.integers(0, 256, 5000, dtype=np.uint8)
    b = f > 0
    wide = {"i64": rng.integers(-2**62, 2**62, 1200),
            "f64": rng.standard_normal(900),
            "c64": (rng.standard_normal(400)
                    + 1j * rng.standard_normal(400)).astype(np.complex64)}
    ref = {"f": jnp.asarray(f), "bf": jnp.asarray(f).astype(jnp.bfloat16),
           "i": jnp.asarray(i), "u": jnp.asarray(u), "b": jnp.asarray(b),
           "tree": {"w": jnp.asarray(f), "layers": [jnp.asarray(i), None]},
           **wide}
    port = {"f": torch.from_numpy(f.copy()),
            "bf": torch.from_numpy(f.copy()).to(torch.bfloat16),
            "i": torch.from_numpy(i.copy()), "u": torch.from_numpy(u.copy()),
            "b": torch.from_numpy(b.copy()),
            "tree": {"w": torch.from_numpy(f.copy()),
                     "layers": [torch.from_numpy(i.copy()), None]},
            **{k: torch.from_numpy(v.copy()) for k, v in wide.items()}}
    return ref, port


def _reducers(codec="zlib", **kw):
    return (RefReducer(codec=codec, chunk_bytes=CHUNK, **kw),
            StateReducer(codec=codec, chunk_bytes=CHUNK, device="cpu", **kw))


def _ser_view(ser) -> dict:
    return {
        "codec": ser.codec,
        "blobs": {n: (b.pickle_bytes, [dict(m) for m in b.arrays])
                  for n, b in ser.blobs.items()},
        "chunks": dict(ser.chunks), "digests": dict(ser.digests),
        "skipped": ser.skipped, "nbytes": ser.nbytes,
        "ref_nbytes": ser.ref_nbytes,
    }


@pytest.mark.parametrize("kind", ["host", "device"])
def test_digest_many_bit_identical(kind):
    rr, pr = _reducers()
    if kind == "host":
        ref_ns = port_ns = _host_ns()
    else:
        ref_ns, port_ns = _device_pairs()
    assert pr.digest_many(port_ns) == rr.digest_many(ref_ns)
    for n in port_ns:
        assert pr.digest(port_ns[n]) == rr.digest(ref_ns[n]), n


def test_torch_leaf_digests_as_its_numpy_twin():
    """H7: a wide tensor is re-laned where it lies and digests as the numpy
    array of the same values does in the reference."""
    _, pr = _reducers()
    rr, _ = _reducers()
    _ref, port = _device_pairs(3)
    for name in ("i64", "f64", "c64"):
        twin = port[name].numpy()
        assert pr.digest(port[name]) == rr.digest(twin) == pr.digest(twin)


@pytest.mark.parametrize("kind", ["host", "device"])
def test_delta_names_bit_identical(kind):
    rr, pr = _reducers()
    if kind == "host":
        ref_ns = port_ns = _host_ns()
    else:
        ref_ns, port_ns = _device_pairs()
    names = set(port_ns)
    known = dict(rr.digest_many(ref_ns))
    for stale in sorted(names)[::3]:
        known[stale] ^= 1
    known.pop(sorted(names)[1])
    known["gone"] = 5                                      # a tombstone
    want = rr.delta_names(RefState(dict(ref_ns)), names, known)
    got = pr.delta_names(ExecutionState(dict(port_ns)), names, known)
    assert got == want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", ["host", "device"])
def test_serialize_names_bit_identical(codec, kind):
    rr, pr = _reducers(codec)
    if kind == "host":
        ref_ns = port_ns = _host_ns()
    else:
        ref_ns, port_ns = _device_pairs()
    names = set(port_ns)
    want = rr.serialize_names(RefState(dict(ref_ns)), names)
    got = pr.serialize_names(ExecutionState(dict(port_ns)), names)
    assert _ser_view(got) == _ser_view(want)


@pytest.mark.parametrize("nbytes", [1, 1023, 8192, 8193, 40_000])
def test_array_chunk_digests_match_reference(nbytes):
    from repro.core.chunkstore import array_chunk_digests as ref_digests
    from repro_torch.core.chunkstore import array_chunk_digests
    raw = np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    for chunk in (CHUNK, 0, 1 << 18):
        assert (array_chunk_digests(raw, chunk, device="cpu")
                == ref_digests(raw, chunk)), chunk


def test_chunk_priors_reuse_gives_the_same_keys():
    """Re-serializing after a one-element change rides the compare path in
    both packages and gives the same chunk keys."""
    rr, pr = _reducers("none")
    ns = _host_ns()
    big = ns["big"].copy()
    ref_state, port_state = RefState({"big": big}), ExecutionState(
        {"big": big.copy()})
    assert (_ser_view(pr.serialize_names(port_state, {"big"}))
            == _ser_view(rr.serialize_names(ref_state, {"big"})))
    ref_state["big"][10_000] += 1.0
    port_state["big"][10_000] += 1.0
    a = rr.serialize_names(ref_state, {"big"})
    b = pr.serialize_names(port_state, {"big"})
    assert _ser_view(b) == _ser_view(a)


def _assert_same_objects(got, want):
    assert set(got) == set(want)
    for n in want:
        g, w = got[n], want[n]
        if isinstance(w, (list, tuple, dict)):
            assert jax.tree_util.tree_structure(w) == \
                jax.tree_util.tree_structure(g)
            gl, wl = jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)
        else:
            gl, wl = [g], [w]
        for x, y in zip(gl, wl):
            if isinstance(x, torch.Tensor):          # bf16 decodes as a tensor
                assert x.dtype == torch.bfloat16 and str(y.dtype) == "bfloat16"
                np.testing.assert_array_equal(
                    x.view(torch.int16).numpy(), np.asarray(y).view(np.int16))
            elif isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("codec", CODECS)
def test_each_package_reads_the_others_serialized_state(codec):
    rr, pr = _reducers(codec)
    ref_ns, port_ns = _device_pairs()
    ref_ns = {**ref_ns, **_host_ns()}
    port_ns = {**port_ns, **_host_ns()}
    ref_ser = rr.serialize_names(RefState(ref_ns), set(ref_ns))
    port_ser = pr.serialize_names(ExecutionState(port_ns), set(port_ns))
    want = rr.deserialize(ref_ser)
    _assert_same_objects(pr.deserialize(ref_ser), want)
    _assert_same_objects(rr.deserialize(port_ser), want)
    _assert_same_objects(pr.deserialize(port_ser), want)


def test_cell_defined_functions_cross_between_packages():
    """A function travels by value; the port rebuilds the reference's
    stream with its own helper, and its own stream differs only by the
    helper's module name (ROADMAP queue C)."""
    rr, pr = _reducers("zlib")
    cell_ns: dict = {}
    exec("k = 3\ndef bump(x):\n    return x + k\n", cell_ns)  # noqa: S102
    ns = {"bump": cell_ns["bump"]}
    ref_ser = rr.serialize_names(RefState(ns), {"bump"})
    port_ser = pr.serialize_names(ExecutionState(ns), {"bump"})
    fn = pr.deserialize(ref_ser, target_ns={"k": 10})["bump"]
    assert fn(1) == 11                      # globals bind at the receiver
    # the reference rebuilds the port's function through the port's helper,
    # which does not see the reference's target namespace: the code
    # arrives, its globals do not bind (ROADMAP queue C)
    fn = rr.deserialize(port_ser, target_ns={"k": 10})["bump"]
    assert fn.__code__.co_code == ns["bump"].__code__.co_code
    ref_raw = rr.serialize_names(RefState(ns), {"bump"}, codec="none")
    port_raw = pr.serialize_names(ExecutionState(ns), {"bump"}, codec="none")
    mine, theirs = (port_raw.blobs["bump"].pickle_bytes,
                    ref_raw.blobs["bump"].pickle_bytes)
    assert b"repro_torch.core.reducer" in mine
    assert b"repro.core.reducer" in theirs
    assert len(mine) - len(theirs) == len("_torch")


def test_float64_under_quant8_comes_back_float32_as_in_the_reference():
    """H4: the reference narrows a float64 leaf to float32 to quantize it and
    decodes it as float32 under a float64 meta; the port gives the same."""
    rr, pr = _reducers("quant8+zstd")
    x = np.random.default_rng(4).standard_normal(5000) * 100
    ref_ser = rr.serialize_names(RefState({"x": x}), {"x"})
    port_ser = pr.serialize_names(ExecutionState({"x": x}), {"x"})
    assert _ser_view(port_ser) == _ser_view(ref_ser)
    assert port_ser.blobs["x"].arrays[0]["dtype"] == "float64"
    want, got = rr.deserialize(ref_ser)["x"], pr.deserialize(port_ser)["x"]
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_disk_chunk_store_is_shared_between_packages(tmp_path):
    rr, pr = _reducers("zlib")
    ns = _host_ns()
    port_ser = pr.serialize_names(ExecutionState(ns), set(ns))
    ref_ser = rr.serialize_names(RefState(ns), set(ns))
    DiskChunkStore(str(tmp_path / "p")).put_many(port_ser.chunks)
    RefDisk(str(tmp_path / "r")).put_many(ref_ser.chunks)
    for mine, theirs, ser in ((DiskChunkStore, RefDisk, port_ser),
                              (RefDisk, DiskChunkStore, ref_ser)):
        side = "p" if ser is port_ser else "r"
        store = theirs(str(tmp_path / side))
        assert store.digests() == set(ser.chunks)
        for d, c in ser.chunks.items():
            assert store.get(d) == c
    # a state whose chunks live only in the other package's store
    stripped = type(port_ser)(codec=port_ser.codec, blobs=port_ser.blobs,
                              digests=port_ser.digests)
    _assert_same_objects(
        rr.deserialize(stripped, chunk_store=RefDisk(str(tmp_path / "p"))),
        pr.deserialize(ref_ser))


@pytest.mark.parametrize("obj", [
    {"b": 1, "a": [2, (3,)], "c": None}, [1], (1,), (), [], {}, None,
    {"x": {}}, [None, 1], {1: 1, 2: 2}, ([1], {"k": (None, 1)}),
    {"a\"b": 1, "it's": 2}, {(1, 2): 1, (0, 5): 2}, np.zeros(2),
], ids=repr)
def test_tree_flatten_matches_jax(obj):
    """H5: the port's flatten gives jax's leaves and treedef string."""
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    got_leaves, got_treedef = _tree_flatten(obj)
    assert got_treedef == str(treedef)
    assert len(got_leaves) == len(leaves)
    assert all(a is b for a, b in zip(got_leaves, leaves))


Pair = namedtuple("P", ["w", "b"])


def _containers(a, b) -> dict:
    """Names holding jax's other built-in nodes, built from arrays a, b."""
    return {
        "od": OrderedDict([("b", a), ("a", b)]),            # insertion order
        "dd": defaultdict(list, {"b": a, "a": b}),          # keys sorted
        "nt": Pair(a, b),
        "nested": {"layer": Pair(a, None), "opt": OrderedDict(m=b),
                   "hist": [defaultdict(int, {2: a, 1: (b,)})]},
    }


@pytest.mark.parametrize("name", ["od", "dd", "nt", "nested"])
def test_tree_flatten_makes_nodes_of_ordered_default_and_named(name):
    """H5 repaired: OrderedDict, defaultdict and namedtuple are nodes, as in
    jax, with jax's treedef strings."""
    obj = _containers(np.zeros(2), np.ones(3))[name]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    got_leaves, got_treedef = _tree_flatten(obj)
    assert got_treedef == str(treedef)
    assert len(got_leaves) == len(leaves) == (4 if name == "nested" else 2)
    assert all(x is y for x, y in zip(got_leaves, leaves))


def test_tree_flatten_treedef_strings_as_jax_prints_them():
    c = _containers(np.zeros(2), np.ones(3))
    assert _tree_flatten(c["od"])[1] == \
        "PyTreeDef(CustomNode(OrderedDict[('b', 'a')], [*, *]))"
    assert _tree_flatten(c["dd"])[1] == \
        "PyTreeDef(CustomNode(defaultdict[(<class 'list'>, ('a', 'b'))], [*, *]))"
    assert _tree_flatten(c["nt"])[1] == \
        "PyTreeDef(CustomNode(namedtuple[P], [*, *]))"
    # subclasses of the dict types stay leaves, as in jax
    sub = type("Sub", (OrderedDict,), {})(a=np.zeros(1))
    assert _tree_flatten(sub)[1] == str(jax.tree_util.tree_flatten(sub)[1])


@pytest.mark.parametrize("kind", ["host", "device"])
def test_digest_many_of_containers_matches_the_reference(kind):
    rr, pr = _reducers()
    rng = np.random.default_rng(4)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.integers(0, 9, 700).astype(np.int32)
    if kind == "host":
        ref_ns = port_ns = _containers(a, b)
    else:
        ref_ns = _containers(jnp.asarray(a), jnp.asarray(b))
        port_ns = _containers(torch.from_numpy(a), torch.from_numpy(b))
    assert pr.digest_many(port_ns) == rr.digest_many(ref_ns)
    for n in port_ns:
        assert pr.digest(port_ns[n]) == rr.digest(ref_ns[n]), n


@dataclasses.dataclass
class Params:
    """An unregistered dataclass: a leaf in jax and in the port."""
    w: np.ndarray
    b: np.ndarray
    name: str = "layer"


class Holder:
    """A plain class instance: a leaf in both packages."""

    def __init__(self, w, b):
        self.w, self.b = w, b


def _leaf_objects():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((40, 30)).astype(np.float32)
    b = rng.integers(0, 9, 30).astype(np.int32)
    return {"params": Params(w, b), "holder": Holder(w, b),
            "nested": {"p": [Params(w, b)], "h": (Holder(b, w),)}}


def test_dataclass_and_plain_instance_digest_as_in_the_reference():
    """Neither package makes a node of an unregistered dataclass or of a
    plain instance: each is one pickled leaf, with the same digest."""
    rr, pr = _reducers()
    ns = _leaf_objects()
    assert pr.digest_many(ns) == rr.digest_many(ns)
    for n, obj in ns.items():
        assert pr.digest(obj) == rr.digest(obj), n
        assert _tree_flatten(obj)[1] == \
            str(jax.tree_util.tree_flatten(obj)[1]), n


def test_a_registered_dataclass_stays_a_leaf_in_the_port():
    """Documented difference (ROADMAP queue C): jax makes a node of a
    dataclass registered in its pytree registry, which the port cannot read
    without importing jax; the port digests it as the leaf it would be
    unregistered."""
    @dataclasses.dataclass
    class Registered:
        w: np.ndarray
        b: np.ndarray

    jax.tree_util.register_dataclass(Registered, data_fields=["w", "b"],
                                     meta_fields=[])
    w, b = np.arange(6, dtype=np.float32), np.ones(3, np.int32)
    obj = Registered(w, b)
    assert len(jax.tree_util.tree_leaves(obj)) == 2       # a node in jax
    leaves, treedef = _tree_flatten(obj)
    assert leaves == [obj] and treedef == "PyTreeDef(*)"  # a leaf here


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        StateReducer()
