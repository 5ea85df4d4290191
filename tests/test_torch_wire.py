"""The port's wire format against the JAX reference's, on the CPU.

Both packages speak one wire format, so every byte must agree: the golden
streams in ``tests/data`` decode and re-encode byte for byte in the port;
a real ``SerializedState`` encoded by either package is the same byte
stream and decodes in the other; truncated and corrupted streams are
refused exactly where the reference refuses them.
"""
import os

import numpy as np
import pytest

from repro.core import wire as ref_wire
from repro.core.chunkstore import MemoryChunkStore as RefStore
from repro.core.reducer import StateReducer as RefReducer
from repro.core.state import ExecutionState as RefState
from repro_torch.core import wire
from repro_torch.core.chunkstore import (
    MemoryChunkStore, digest_bytes, encode_chunk,
)
from repro_torch.core.reducer import (
    SerializedName, SerializedState, StateReducer,
)
from repro_torch.core.state import ExecutionState
from repro_torch.core.wire import Frame, FrameDecoder, WireError

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "wire_v1_golden.bin")
GATEWAY_GOLDEN = os.path.join(DATA, "wire_gateway_golden.bin")
GOLDEN_HELLO_HEX = "0800000001525749520100000005833bd2"
GOLDEN_DETACH_HEX = ("280000000e7b22726561736f6e223a22636f6d706c657465222c"
                     "2273657373696f6e223a22732d30303031227d3ca3eb6f")
PACKAGES = {"reference": ref_wire, "port": wire}


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _frames(frames):
    """Frames of either package as comparable (type, payload bytes)."""
    return [(f.ftype, bytes(f.payload)) for f in frames]


def _decode_or_error(mod, data):
    try:
        return _frames(mod.decode_frames(data))
    except mod.WireError:
        return "WireError"


# ----------------------------------------------------------------------
# golden vectors
# ----------------------------------------------------------------------

def test_v1_golden_decodes_and_reencodes_byte_for_byte():
    data = _read(GOLDEN)
    frames = wire.decode_frames(data)
    assert [f.ftype for f in frames] == [
        wire.HELLO, wire.MANIFEST, wire.ACK, wire.CHUNK, wire.TOMBSTONE,
        wire.END, wire.ACK]
    assert b"".join(f.encoded() for f in frames) == data
    assert frames[0].encoded().hex() == GOLDEN_HELLO_HEX
    hello = wire.parse_hello(frames[0])
    assert hello == ref_wire.parse_hello(ref_wire.decode_frames(data)[0])
    assert hello["version"] == wire.VERSION == ref_wire.VERSION
    assert _frames(frames) == _frames(ref_wire.decode_frames(data))


def test_v1_golden_manifest_roundtrips_in_the_port():
    frames = wire.decode_frames(_read(GOLDEN))
    ser, deleted, modules, spec, trickle = wire.parse_manifest(frames[1])
    raw = bytes(range(64)) * 4
    d = digest_bytes(raw)
    assert isinstance(ser, SerializedState)
    assert (deleted, modules, spec, trickle) == (("gone",), ("np=numpy",),
                                                 False, False)
    assert ser.digests == {"w": 0x1122334455667788, "tag": 42}
    assert ser.blobs["w"].arrays[0]["chunks"] == [d]
    assert isinstance(ser.blobs["tag"], SerializedName)
    again = wire.manifest_frame(ser, deleted=deleted, modules=modules)
    assert again.payload == frames[1].payload
    digest, encoded = wire.parse_chunk(frames[3])
    assert digest == d and encoded == encode_chunk(raw, "none")


def _gateway_frames(mod):
    return [
        mod.attach_frame("alice", "nb0",
                         [{"source": "x = 1", "cost": 0.5},
                          {"source": "y = x * 2", "cost": 30.0}],
                         think=[1.5, 0.25], session="s-0001"),
        mod.json_frame(mod.ACK, {"queued": "s-0001"}),
        mod.stream_frame(5, mod.json_frame(
            mod.ACK, {"session": "s-0001", "warm": True})),
        mod.stream_frame(6, mod.detach_frame("s-0001", "client")),
        mod.detach_frame("s-0001", "complete"),
    ]


def test_gateway_golden_decodes_and_reencodes_byte_for_byte():
    data = _read(GATEWAY_GOLDEN)
    frames = wire.decode_frames(data)
    assert [f.ftype for f in frames] == [
        wire.ATTACH, wire.ACK, wire.STREAM, wire.STREAM, wire.DETACH]
    assert b"".join(f.encoded() for f in frames) == data
    assert frames[4].encoded().hex() == GOLDEN_DETACH_HEX
    # the port's encoders emit the committed bytes
    assert b"".join(f.encoded() for f in _gateway_frames(wire)) == data
    doc = wire.parse_attach(frames[0])
    assert doc == ref_wire.parse_attach(ref_wire.decode_frames(data)[0])
    again = wire.attach_frame(doc["tenant"], doc["notebook"], doc["cells"],
                              think=doc["think"], session=doc["session"])
    assert again.encoded() == frames[0].encoded()
    sid, inner = wire.parse_stream(frames[3])
    assert sid == 6 and wire.parse_detach(inner) == ("s-0001", "client")
    assert inner.encoded() == wire.detach_frame("s-0001", "client").encoded()


# ----------------------------------------------------------------------
# a real state across packages
# ----------------------------------------------------------------------

def _namespace():
    rng = np.random.default_rng(11)
    return {"a": rng.standard_normal(3000).astype(np.float32),
            "img": (rng.random((40, 30, 3)) * 255).astype(np.uint8),
            "w64": rng.standard_normal((50, 7)),
            "tree": {"k": [1, 2, 3], "v": (np.arange(9, dtype=np.int32),)},
            "label": "edges"}


def _reducers(codec):
    return (RefReducer(codec=codec, chunk_bytes=4096),
            StateReducer(codec=codec, chunk_bytes=4096, device="cpu"))


def _stream(mod, ser, deleted=("gone",), modules=("np=numpy",)) -> bytes:
    frames = [mod.hello_frame(ser.codec),
              mod.manifest_frame(ser, deleted=deleted, modules=modules)]
    frames += list(mod.state_stream_frames(ser, sorted(ser.chunks),
                                           deleted=deleted))
    return b"".join(f.encoded() for f in frames)


def _receive(mod, store, reducer, data):
    frames = mod.decode_frames(data)
    ser, deleted, modules, _, _ = mod.parse_manifest(frames[1])
    for f in frames:
        if f.ftype == mod.CHUNK:
            store.ingest_frame(f)
    return reducer.deserialize(ser, chunk_store=store), deleted, modules


def _same_objects(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        elif k == "tree":
            assert got[k]["k"] == want[k]["k"]
            np.testing.assert_array_equal(got[k]["v"][0], want[k]["v"][0])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("codec", ["none", "zlib", "quant8+zstd"])
def test_a_serialized_state_crosses_between_the_packages(codec):
    ref_red, port_red = _reducers(codec)
    ns = _namespace()
    names = set(ns)
    ref_ser = ref_red.serialize_names(RefState(dict(ns)), names)
    port_ser = port_red.serialize_names(ExecutionState(dict(ns)), names)
    ref_bytes, port_bytes = _stream(ref_wire, ref_ser), _stream(wire, port_ser)
    # one state, one wire stream: the chunk keys and payloads agree
    assert port_bytes == ref_bytes
    assert port_ser.digests == ref_ser.digests
    # the port decodes the reference's stream, and the reverse
    into_port, dead, mods = _receive(wire, MemoryChunkStore(), port_red,
                                     ref_bytes)
    into_ref, dead_r, mods_r = _receive(ref_wire, RefStore(), ref_red,
                                        port_bytes)
    assert (dead, mods) == (dead_r, mods_r) == (("gone",), ("np=numpy",))
    _same_objects(into_port, into_ref)
    if codec != "quant8+zstd":                 # lossless: what was sent
        _same_objects(into_port, ns)


# ----------------------------------------------------------------------
# damage: refused where the reference refuses
# ----------------------------------------------------------------------

def test_truncation_is_refused_as_the_reference_refuses_it():
    for path in (GOLDEN, GATEWAY_GOLDEN):
        data = _read(path)
        for cut in sorted({1, 4, 8, 9, 12, len(data) // 3, len(data) // 2,
                           len(data) - 5, len(data) - 1}):
            got = _decode_or_error(wire, data[:cut])
            assert got == _decode_or_error(ref_wire, data[:cut]) == \
                "WireError", (path, cut)


@pytest.mark.parametrize("flip", [1, 0x80, 0xff])
def test_bitflips_are_refused_as_the_reference_refuses_them(flip):
    """Every byte position, three flips each: both packages raise, or both
    decode the same frames (never a different successful decode)."""
    for path in (GOLDEN, GATEWAY_GOLDEN):
        data = _read(path)
        good = _frames(wire.decode_frames(data))
        for pos in range(len(data)):
            bad = bytearray(data)
            bad[pos] ^= flip
            got = _decode_or_error(wire, bytes(bad))
            assert got == _decode_or_error(ref_wire, bytes(bad)), (path, pos)
            assert got in ("WireError", good)


def test_frame_level_rejections_match_the_reference():
    cases = [wire.encode_frame(99, b"?")]
    bad = bytearray(wire.encode_frame(wire.END, b""))
    bad[0:4] = (wire.MAX_PAYLOAD + 1).to_bytes(4, "little")
    cases.append(bytes(bad))
    for data in cases:
        assert _decode_or_error(wire, data) == \
            _decode_or_error(ref_wire, data) == "WireError"


@pytest.mark.parametrize("name", ["reference", "port"])
def test_parsers_refuse_damaged_documents(name):
    """The same damaged documents are refused by both packages' parsers."""
    mod = PACKAGES[name]
    frames = mod.decode_frames(_read(GOLDEN))
    manifest = frames[1]
    for payload in (bytes(manifest.payload).replace(b'"blobs"', b'"blogs"'),
                    b"\xff\xfe{"):
        with pytest.raises(mod.WireError):
            mod.parse_manifest(mod.Frame(mod.MANIFEST, payload))
    hello = mod.hello_frame()
    with pytest.raises(mod.WireError):
        mod.parse_hello(mod.Frame(mod.HELLO, b"XXXX" + hello.payload[4:]))
    bad_ver = bytearray(hello.payload)
    bad_ver[4] = 0xEE
    with pytest.raises(mod.WireError):
        mod.parse_hello(mod.Frame(mod.HELLO, bytes(bad_ver)))
    with pytest.raises(mod.WireError):
        mod.parse_hello(mod.Frame(mod.END))
    for bad in ({"notebook": "nb"}, {"tenant": "t", "notebook": "nb",
                                     "cells": "x"}):
        with pytest.raises(mod.WireError):
            mod.parse_attach(mod.json_frame(mod.ATTACH, bad))
    with pytest.raises((mod.WireError, ValueError)):
        mod.stream_frame(-1, mod.Frame(mod.END))


def test_chunk_ingest_refuses_an_unknown_codec_tag():
    store = MemoryChunkStore()
    with pytest.raises(WireError):
        store.ingest_frame(wire.chunk_frame(7, b"\x7fgarbage"))
    enc = encode_chunk(b"payload", "none")
    d = digest_bytes(b"payload")
    assert store.ingest_frame(wire.chunk_frame(d, enc)) == d
    assert store.get(d) == enc


def test_decoder_takes_one_byte_at_a_time_and_keeps_chunk_views():
    frames = [wire.hello_frame(), Frame(wire.END),
              wire.json_frame(wire.ACK, {"need": []})]
    data = b"".join(f.encoded() for f in frames)
    dec = FrameDecoder()
    out = []
    for i in range(len(data)):
        dec.feed(data[i:i + 1])
        out.extend(dec.frames())
    assert out == frames and dec.pending_bytes == 0
    body = b"\x00" + os.urandom(1 << 20)
    buf = wire.chunk_frame(123456789, body).encoded()
    dec.feed(buf)
    (f,) = tuple(dec.frames())
    d, enc = wire.parse_chunk(f)
    assert d == 123456789 and isinstance(enc, memoryview)
    assert enc.obj is buf and bytes(enc) == body
