"""The port's transport plane on the CPU: the cases of
``tests/test_transport.py`` and ``tests/test_mux.py`` that need no fleet
scheduler, run on ``repro_torch``; a migration across the two packages
over one real TCP socket in each direction; one ``SubprocessEnv`` run;
``--transport socket`` on the port's launcher against the reference's;
and the port's transport plane imported and driven with jax unimportable.

Every socket read has a timeout (the transports' own 60 s default, or
shorter here), every accept happens on a socket that is already
connected, and every thread join and child process wait is bounded, so a
hung peer fails a test instead of stalling the suite.
"""
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.migration as ref_migration  # noqa: E402
import repro.core.transport as ref_transport  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.migration as port_migration  # noqa: E402
import repro_torch.core.transport as port_transport  # noqa: E402
from repro.launch.notebook import run_notebook as ref_run  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.chunkstore import MemoryChunkStore  # noqa: E402
from repro_torch.core.fabric import (  # noqa: E402
    EnvironmentRegistry, ExecutionEnvironment,
)
from repro_torch.core.migration import (  # noqa: E402
    MigrationEngine, PipelinedMigrationEngine,
)
from repro_torch.core.reducer import (  # noqa: E402
    SerializationFailure, StateReducer,
)
from repro_torch.core.state import ExecutionState  # noqa: E402
from repro_torch.core.transport import (  # noqa: E402
    DigestMirrorStore, LoopbackTransport, MigrationPeer, MuxEnvServer,
    MuxPeer, SocketTransport, SubprocessEnv, TokenBucket, WireReceiver,
    attach_peer,
)
from repro_torch.core.wire import Frame, WireError  # noqa: E402
from repro_torch.launch import notebook as port_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOIN = 10.0          # seconds any thread or child may take to finish


def _reducer(codec="zlib", **kw):
    return StateReducer(codec=codec, device="cpu", **kw)


def _rig(kind, *, pipeline=False, shaper=None):
    reg = EnvironmentRegistry.two_env()
    red = _reducer()
    cls = PipelinedMigrationEngine if pipeline else MigrationEngine
    eng = cls(red, registry=reg)
    peer = attach_peer(reg["remote"], red, kind=kind, shaper=shaper)
    return reg, red, eng, peer


def _close(peer, env):
    """Close a peer and wait (bounded) for its in-process server thread."""
    peer.close()
    env._server.join(JOIN)
    assert not env._server.thread.is_alive()


def _socket_pair():
    """Two connected ``SocketTransport``s over localhost TCP."""
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(JOIN)
    client = socket.create_connection(("127.0.0.1", srv.getsockname()[1]),
                                      timeout=JOIN)
    conn, _ = srv.accept()
    srv.close()
    return SocketTransport(client), SocketTransport(conn)


# ----------------------------------------------------------------------
# tests/test_transport.py, on the port
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["loopback", "socket"])
def test_push_exec_pull_over_transport(kind):
    reg, red, eng, peer = _rig(kind)
    local, remote = reg["local"], reg["remote"]
    local.state.ns["x"] = np.arange(1000, dtype=np.float32)
    local.state.ns["msg"] = "hi"
    res = eng.migrate(local, remote, "y = x.sum() + len(msg)")
    assert res.transport == kind and res.wire_frames >= 3
    assert set(res.names) == {"msg", "x"}
    np.testing.assert_array_equal(remote.state.ns["x"], local.state.ns["x"])
    remote.execute("y = x.sum() + len(msg)")
    back = eng.migrate(remote, local, names={"y"})
    assert back.names == ("y",)
    assert local.state.ns["y"] == pytest.approx(float(np.arange(1000).sum()) + 2)
    _close(peer, remote)


def test_delta_and_tombstones_cross_the_wire():
    reg, red, eng, peer = _rig("socket")
    local, remote = reg["local"], reg["remote"]
    local.state.ns["x"] = np.arange(1000, dtype=np.float32)
    first = eng.migrate(local, remote, "z = x * 2")
    assert not first.noop and first.nbytes > 0
    again = eng.migrate(local, remote, "z = x * 2")
    assert again.noop and again.nbytes == 0
    del local.state.ns["x"]
    gone = eng.migrate(local, remote, None)
    assert "x" in gone.deleted and "x" not in remote.state.ns
    _close(peer, remote)


def test_chunk_level_dedup_over_socket():
    reg = EnvironmentRegistry.two_env()
    red = _reducer("none", chunk_bytes=4096)
    eng = MigrationEngine(red, registry=reg)
    local, remote = reg["local"], reg["remote"]
    peer = attach_peer(remote, red, kind="socket")
    local.state.ns["big"] = np.arange(64_000, dtype=np.float32)
    full = eng.migrate(local, remote, "s = big.sum()")
    local.state.ns["big"][7] = 1.0
    eng.invalidate("local", ["big"])
    delta = eng.migrate(local, remote, "s = big.sum()")
    assert delta.nbytes < full.nbytes / 10
    assert delta.wire_frames < full.wire_frames
    np.testing.assert_array_equal(remote.state.ns["big"], local.state.ns["big"])
    _close(peer, remote)


def test_prefetch_claim_and_cancel_send_real_frames():
    reg, red, eng, peer = _rig("socket", pipeline=True)
    local, remote = reg["local"], reg["remote"]
    local.state.ns["x"] = np.arange(2000, dtype=np.float32)
    p = eng.begin_prefetch(local, remote, "y = x + 1", now=0.0)
    assert p is not None and p.peer is not None
    assert "x" not in remote.state.ns
    res = eng.migrate(local, remote, "y = x + 1", now=p.ready_at + 1.0)
    assert "x" in res.prefetched
    assert res.wire_frames >= 2 and res.transport == "socket"
    np.testing.assert_array_equal(remote.state.ns["x"], local.state.ns["x"])
    local.state.ns["q"] = np.ones(100)
    eng.begin_prefetch(local, remote, "w = q * 2", now=10.0)
    eng.cancel_prefetch("remote", now=20.0)
    assert eng.prefetch_cancelled == 1
    ok = eng.migrate(local, remote, "w = q * 2")
    assert "q" in ok.names or ok.noop
    _close(peer, remote)


def test_module_alias_reaches_remote_even_on_empty_state_delta():
    reg, red, eng, peer = _rig("socket")
    local, remote = reg["local"], reg["remote"]
    local.state.ns["x"] = 1
    local.state.ns["math"] = math
    eng.migrate(local, remote, "x")
    res = eng.migrate(local, remote, "y = math.sqrt(x)")
    assert res.noop and res.wire_frames >= 2
    remote.execute("y = math.sqrt(x)")
    assert remote.state.ns["y"] == 1.0
    _close(peer, remote)


def _poison_unpickle():
    raise ValueError("poisoned unpickle")


class _Poison:
    """Pickles fine; unpickling raises: a receiver-side apply failure."""

    def __reduce__(self):
        return (_poison_unpickle, ())


def test_receiver_apply_failure_reports_promptly_and_keeps_serving():
    reg, red, eng, peer = _rig("socket")
    local, remote = reg["local"], reg["remote"]
    local.state.ns["p"] = _Poison()
    t0 = time.perf_counter()
    with pytest.raises(WireError, match="poisoned unpickle"):
        eng.migrate(local, remote, names={"p"})
    assert time.perf_counter() - t0 < 10.0
    del local.state.ns["p"]
    eng.invalidate("local", ["p"])
    local.state.ns["ok"] = np.arange(10)
    res = eng.migrate(local, remote, names={"ok"})
    assert "ok" in res.names
    np.testing.assert_array_equal(remote.state.ns["ok"], np.arange(10))
    _close(peer, remote)


def test_serialization_failure_travels_as_error_frame():
    reg, red, eng, peer = _rig("socket")
    local, remote = reg["local"], reg["remote"]
    sock = socket.socket()
    try:
        remote.state.ns["sock"] = sock          # unpicklable
        with pytest.raises(SerializationFailure):
            eng.migrate(remote, local, names={"sock"}, strict=True)
        res = eng.migrate(remote, local, names={"sock"}, strict=False)
        assert res.names == ()
    finally:
        sock.close()
    _close(peer, remote)


def test_token_bucket_math_is_deterministic():
    t = [0.0]
    bucket = TokenBucket(1000.0, burst=500, latency=0.25, clock=lambda: t[0])
    assert bucket.delay(500) == pytest.approx(0.25)
    assert bucket.delay(1000) == pytest.approx(1.25)
    t[0] = 10.0
    assert bucket.delay(100) == pytest.approx(0.25)


def test_two_lane_bucket_interactive_never_pays_trickle_deficit():
    t = [0.0]
    bucket = TokenBucket(1000.0, burst=1000, latency=0.0, clock=lambda: t[0])
    assert bucket.delay(5000, low_priority=True) == pytest.approx(4.0)
    assert bucket.delay(800) == pytest.approx(0.8)
    bucket.delay(10_000, low_priority=True)
    assert bucket.delay(800) <= 0.8 + 1e-9
    assert bucket.delay(100, low_priority=True) < float("inf")


def test_shaped_socket_transfer_is_slower_but_identical():
    shaper = TokenBucket(200_000.0, burst=2048, latency=0.0)
    reg, red, eng, peer = _rig("socket", shaper=shaper)
    local, remote = reg["local"], reg["remote"]
    payload = np.arange(30_000, dtype=np.float32)
    local.state.ns["x"] = payload
    res = eng.migrate(local, remote, "y = x.sum()")
    np.testing.assert_array_equal(remote.state.ns["x"], payload)
    assert res.wall_seconds > 0.05
    _close(peer, remote)


def test_shaped_socket_trickle_yields_to_interactive_frames():
    rate = 1e6
    shaper = TokenBucket(rate, burst=2048, latency=0.0)
    reg, red, eng, peer = _rig("socket", shaper=shaper)
    local, remote = reg["local"], reg["remote"]
    local.state.ns["big"] = np.random.default_rng(0).standard_normal(20_000)
    ser = red.serialize_names(local.state, ["big"])
    t_stats = peer.send_state(ser, trickle=True, low_priority=True)
    assert t_stats.wire_bytes > 50_000
    assert t_stats.wall_seconds >= t_stats.wire_bytes / rate * 0.5
    assert "big" not in remote.state.ns
    local.state.ns["note"] = "ping"
    i_stats = peer.send_state(red.serialize_names(local.state, ["note"]))
    assert "note" in remote.state.ns
    assert i_stats.wall_seconds < t_stats.wire_bytes / rate / 2
    _close(peer, remote)


def test_digest_mirror_store_tracks_without_bytes():
    m = DigestMirrorStore()
    m.put_many({1: b"a", 2: b"b"})
    assert m.has(1) and m.has(2) and not m.has(3)
    assert len(m) == 2 and m.nbytes == 0
    with pytest.raises(KeyError):
        m.get(1)


def test_loopback_transport_is_zero_copy():
    a, b = LoopbackTransport.pair()
    f = Frame(wire.END, b"payload-bytes")
    a.send(f)
    assert b.recv(timeout=1.0) is f
    assert a.bytes_sent == f.wire_size
    a.close()
    with pytest.raises(WireError):
        a.send(f)


def test_set_transport_marks_and_audit_logs_as_the_reference():
    """``EnvironmentRegistry.set_transport`` reaches ``core.transport``."""
    logs = []
    for pkg in (ref_core, port_core):
        reg = pkg.EnvironmentRegistry.two_env()
        reg.set_transport("remote", "socket", now=3.0)
        assert reg["remote"].transport == "socket"
        with pytest.raises(ValueError, match="unknown transport"):
            reg.set_transport("remote", "carrier-pigeon")
        logs.append(list(reg.lifecycle_log))
    assert logs[0] == logs[1]
    assert (3.0, "remote", "transport:loopback", "transport:socket") in logs[1]
    assert port_core.TRANSPORTS == ref_core.TRANSPORTS


# ----------------------------------------------------------------------
# tests/test_mux.py, on the port
# ----------------------------------------------------------------------

def _ser(red, **ns):
    return red.serialize_names(ExecutionState(ns), list(ns))


def _mux_rig(n_streams, *, transport="loopback"):
    if transport == "loopback":
        client_tr, server_tr = LoopbackTransport.pair()
    else:
        client_tr, server_tr = _socket_pair()
    red = _reducer()
    sides = {}

    def make_receiver(sid):
        store, ns = MemoryChunkStore(), {}
        sides[sid] = (store, ns)
        return WireReceiver(store, red, ns=ns)

    server = MuxEnvServer(server_tr, make_receiver, timeout=10.0)
    mux = MuxPeer(client_tr, initiator=True)
    peers = [MigrationPeer(mux.open_stream(), codec="zlib")
             for _ in range(n_streams)]
    return peers, sides, server, client_tr


def _join(server):
    server.join(JOIN)
    assert not server.thread.is_alive() and server.error is None


@pytest.mark.parametrize("transport", ["loopback", "socket"])
def test_n_sessions_share_one_connection(transport):
    peers, sides, server, _ = _mux_rig(3, transport=transport)
    red = _reducer()
    for i, peer in enumerate(peers):
        peer.send_state(_ser(red, x=i, tag=f"s{i}"))
        peer.execute("y = x * 10")
    for peer in peers:
        peer.close()
    _join(server)
    assert server.streams_served == 3 and len(sides) == 3
    for _store, ns in sides.values():
        assert ns["y"] == ns["x"] * 10


def _serve_plain(receiver, transport):
    while True:
        frame = transport.recv(timeout=10.0)
        if frame.ftype == wire.BYE:
            return
        receiver.handle(frame, transport)


def test_per_stream_bytes_equal_dedicated_connection_bytes():
    red = _reducer()

    def run_session(peer, i):
        peer.send_state(_ser(red, x=i, blob=bytes(range(256)) * 8))
        sent_before_exec = peer.transport.bytes_sent
        peer.execute("y = x + 1")
        exec_sent = peer.transport.bytes_sent - sent_before_exec
        peer.close()
        return exec_sent

    dedicated = []
    for i in range(3):
        ctr, str_ = LoopbackTransport.pair()
        rcv = WireReceiver(MemoryChunkStore(), red, ns={})
        t = threading.Thread(target=_serve_plain, args=(rcv, str_),
                             daemon=True)
        t.start()
        exec_sent = run_session(MigrationPeer(ctr, codec="zlib"), i)
        t.join(timeout=JOIN)
        assert not t.is_alive()
        dedicated.append((ctr.frames_sent, ctr.bytes_sent,
                          ctr.frames_recv, exec_sent))
    peers, _sides, server, shared = _mux_rig(3)
    muxed = []
    for i, peer in enumerate(peers):
        exec_sent = run_session(peer, i)
        tr = peer.transport
        muxed.append((tr.frames_sent, tr.bytes_sent,
                      tr.frames_recv, exec_sent))
    _join(server)
    assert muxed == dedicated
    assert shared.bytes_sent > sum(d[1] for d in dedicated)


def test_interleaved_streams_do_not_cross_contaminate():
    peers, sides, server, _ = _mux_rig(4)
    red = _reducer()
    for i, peer in enumerate(peers):
        peer.send_state(_ser(red, x=100 + i))
    for i, peer in enumerate(peers):
        peer.execute(f"y = x - {i}")
    for peer in peers:
        peer.close()
    _join(server)
    assert sorted(ns["y"] for _s, ns in sides.values()) == [100] * 4
    assert sorted(ns["x"] for _s, ns in sides.values()) == [100, 101, 102, 103]


def test_stream_error_is_contained_to_its_stream():
    peers, _sides, server, _ = _mux_rig(2)
    red = _reducer()
    for i, peer in enumerate(peers):
        peer.send_state(_ser(red, x=i))
    with pytest.raises(RuntimeError):
        peers[0].execute("boom()")
    assert peers[1].execute("y = x + 41") >= 0.0
    for peer in peers:
        peer.close()
    _join(server)


def test_per_stream_token_bucket_shapes_that_stream_only():
    client_tr, server_tr = LoopbackTransport.pair()
    mux = MuxPeer(client_tr, initiator=True)
    now = [0.0]
    slow = mux.open_stream(rate=1000.0, burst=100, clock=lambda: now[0])
    fast = mux.open_stream()
    assert slow.bucket is not None and fast.bucket is None
    big = wire.json_frame(wire.ACK, {"pad": "z" * 400})
    first = slow.bucket.delay(big.wire_size)
    second = slow.bucket.delay(big.wire_size)
    assert second > first and second >= big.wire_size / 1000.0 * 0.5
    fast.send(big)
    fast.send(big)
    server_mux = MuxPeer(server_tr, initiator=False)
    stream = server_mux.accept_stream(timeout=5.0)
    assert stream.sid == fast.sid
    assert stream.recv(timeout=5.0).ftype == wire.ACK


def test_poll_on_mux_stream_is_nonblocking():
    client_tr, server_tr = LoopbackTransport.pair()
    a = MuxPeer(client_tr, initiator=True)
    b = MuxPeer(server_tr, initiator=False)
    sa = a.open_stream()
    assert sa.poll() is None
    sa.send(wire.json_frame(wire.ACK, {"n": 1}))
    sb = b.accept_stream(timeout=5.0)
    assert sb.sid == sa.sid
    assert wire.parse_json(sb.recv(timeout=5.0))["n"] == 1
    sb.send(wire.json_frame(wire.ACK, {"n": 2}))
    f = sa.poll()
    assert f is not None and wire.parse_json(f)["n"] == 2
    assert sa.poll() is None


def test_both_ends_can_open_streams_without_id_collision():
    client_tr, server_tr = LoopbackTransport.pair()
    a = MuxPeer(client_tr, initiator=True)
    b = MuxPeer(server_tr, initiator=False)
    a_ids = [a.open_stream().sid for _ in range(3)]
    b_ids = [b.open_stream().sid for _ in range(3)]
    assert a_ids == [1, 3, 5] and b_ids == [2, 4, 6]


def test_persistent_server_survives_stream_churn():
    client_tr, server_tr = LoopbackTransport.pair()
    red = _reducer()
    server = MuxEnvServer(
        server_tr, lambda sid: WireReceiver(MemoryChunkStore(), red, ns={}),
        timeout=10.0, persistent=True)
    mux = MuxPeer(client_tr, initiator=True)
    for round_ in range(3):
        peer = MigrationPeer(mux.open_stream(), codec="zlib")
        peer.send_state(_ser(red, r=round_))
        peer.execute("rr = r * 2")
        peer.close()
    assert server.thread.is_alive() and server.streams_served == 3
    client_tr.close()
    server.join(1.0)        # a loopback close sends nothing: its recv
                            # times out on its own (10 s, daemon thread)


# ----------------------------------------------------------------------
# across the packages: one TCP socket, each direction
# ----------------------------------------------------------------------

PKGS = {"reference": (ref_core, ref_transport),
        "port": (port_core, port_transport)}


def _pkg_reducer(name, codec):
    core = PKGS[name][0]
    kw = {"device": "cpu"} if name == "port" else {}
    return core.StateReducer(codec=codec, chunk_bytes=4096, **kw)


def _namespace(sender):
    rng = np.random.default_rng(5)
    ns = {"x": rng.standard_normal(20_000).astype(np.float32),
          "img": (rng.random((60, 50, 3)) * 255).astype(np.uint8),
          "w64": rng.standard_normal((300, 11)),
          "cfg": {"k": [1, 2, 3], "name": "edges"}, "np": np}
    if sender == "port":        # a tensor travels as an array of its dtype
        ns["t"] = torch.from_numpy(rng.standard_normal(5000).astype(
            np.float32))
    return ns


CELL = "y = float(x.sum()) + float(img.mean()) + w64.shape[0] + len(cfg['k'])"


def _cross_session(sender, receiver, codec):
    """A migration session from ``sender``'s engine into a ``receiver``
    env served over one TCP socket: forward, a one-element delta, a cell
    run remotely, the result pulled home.  Returns what an observer can
    compare across packages."""
    s_core, s_tr = PKGS[sender]
    r_core, r_tr = PKGS[receiver]
    reg = s_core.EnvironmentRegistry.two_env()
    red = _pkg_reducer(sender, codec)
    eng = s_core.MigrationEngine(red, registry=reg)
    local, mirror = reg["local"], reg["remote"]
    target = r_core.ExecutionEnvironment("remote")
    client_sock, server_sock = socket.socketpair()
    for sk in (client_sock, server_sock):
        sk.settimeout(JOIN)
    server = r_tr.EnvServer(target, _pkg_reducer(receiver, codec),
                            r_tr.SocketTransport(server_sock))
    mirror.peer = s_tr.MigrationPeer(s_tr.SocketTransport(client_sock),
                                     codec=codec)
    mirror.transport = "socket"
    try:
        local.state.ns.update(_namespace(sender))
        results = [eng.migrate(local, mirror, CELL)]
        local.state.ns["x"][123] += 1.0
        eng.invalidate("local", ["x"])
        results.append(eng.migrate(local, mirror, CELL))
        mirror.peer.execute(CELL)
        results.append(eng.migrate(mirror, local, names={"y"}))
    finally:
        mirror.peer.close()
        server.join(JOIN)
    assert not server.thread.is_alive() and server.error is None
    received = {k: v for k, v in target.state.ns.items()
                if k not in ("__builtins__", "np")}
    return {"received": received, "chunk_keys": target.chunk_store.digests(),
            "home_y": local.state.ns["y"],
            "log": [(r.src, r.dst, r.names, r.nbytes, r.wire_frames)
                    for r in results]}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, k


@pytest.mark.parametrize("codec", ["zlib", "quant8+zstd"])
@pytest.mark.parametrize("sender,receiver", [("reference", "port"),
                                             ("port", "reference")])
def test_a_migration_crosses_one_socket_between_the_packages(
        sender, receiver, codec):
    """The receiving package's namespace, chunk store and the result that
    comes home equal those of the sender's package talking to itself."""
    got = _cross_session(sender, receiver, codec)
    want = _cross_session(sender, sender, codec)
    _same(got["received"], want["received"])
    assert got["chunk_keys"] == want["chunk_keys"] and got["chunk_keys"]
    assert got["home_y"] == want["home_y"]
    assert got["log"] == want["log"]
    fwd, delta, home = got["log"]
    assert "x" in fwd[2] and delta[2] == ("x",) and home[2] == ("y",)
    assert delta[3] < fwd[3] / 5          # one 4 KiB chunk of x, not all


# ----------------------------------------------------------------------
# a child process: SubprocessEnv and --transport socket
# ----------------------------------------------------------------------

def test_subprocess_env_end_to_end():
    """Migrate a namespace into a child ``repro_torch.core.remote_worker``
    (its reducer on the CPU) over real TCP, run a cell there, bring the
    result home, and see the child exit 0 at BYE."""
    reg = EnvironmentRegistry()
    reg.register(ExecutionEnvironment("local"), home=True)
    sub = SubprocessEnv("worker", speedup=2.0, device="cpu",
                        spawn_timeout=60.0)
    try:
        assert sub.proc.args[-2:] == ["--device", "cpu"]
        assert "repro_torch.core.remote_worker" in sub.proc.args
        reg.register(sub)
        eng = MigrationEngine(_reducer(), registry=reg)
        local = reg["local"]
        local.state.ns["x"] = np.arange(64, dtype=np.float64)
        local.state.ns["t"] = torch.arange(16, dtype=torch.float32)
        local.state.ns["np"] = np
        res = eng.migrate(local, sub, "y = np.square(x).sum() + float(t.sum())")
        assert res.transport == "subprocess" and res.wire_frames >= 3
        assert "x" not in sub.state.ns and len(sub.chunk_store) > 0
        sub.execute("y = np.square(x).sum() + float(t.sum())")
        back = eng.migrate(sub, local, None)
        assert "y" in back.names
        assert local.state.ns["y"] == pytest.approx(
            float(np.square(np.arange(64)).sum()) + 120.0)
        with pytest.raises(RuntimeError):
            sub.execute("raise ValueError('boom')")
        sub.execute("ok = 1")
    finally:
        sub.close()
    assert sub.proc.wait(timeout=JOIN) == 0


NB_CELLS = [
    ("import numpy as np\n"
     "rng = np.random.default_rng(0)\n"
     "xs = rng.standard_normal(60000)\n"
     "img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)\n"
     "def gray(a):\n"
     "    return a.mean(axis=-1)\n"
     "scratch = np.zeros((200, 200))\n", 0.3),
    ("feat = gray(img.astype(np.float32) / 255.0)\n"
     "y = float((xs ** 2).sum())\n", 15.0),
    ("z = y + 1\nxs = xs * 1.0001\n", 0.1),
    ("stats = [float(feat.mean()), float(np.abs(xs).max())]\n", 8.0),
]


def _names_log(monkeypatch, module):
    """Record (src, dst, names, nbytes) of every migration ``module``'s
    engine makes."""
    log = []
    orig = module.MigrationEngine.migrate

    def migrate(self, *args, **kw):
        res = orig(self, *args, **kw)
        log.append((res.src, res.dst, res.names, res.nbytes))
        return res
    monkeypatch.setattr(module.MigrationEngine, "migrate", migrate)
    return log


def test_socket_transport_on_the_launcher_matches_the_reference(
        tmp_path, monkeypatch):
    """``--transport socket --device cpu`` on the port's launcher against
    the reference's ``transport="socket"``: equal decisions, migrations and
    migrated names; bytes differ only by the 6 bytes by which each pickled
    function is longer in the port (its rebuild helper's module name)."""
    nb = {"nbformat": 4, "nbformat_minor": 5, "metadata": {"name": "sock"},
          "cells": [{"id": f"c{i}", "cell_type": "code",
                     "metadata": {"repro": {"cost": cost}}, "source": src}
                    for i, (src, cost) in enumerate(NB_CELLS)]}
    path = tmp_path / "sock.ipynb"
    path.write_text(json.dumps(nb))
    ref_log = _names_log(monkeypatch, ref_migration)
    port_log = _names_log(monkeypatch, port_migration)
    want, _ = ref_run(str(path), sessions=2, codec="zlib", policy="single",
                      transport="socket")
    report = tmp_path / "report.json"
    port_cli.main([str(path), "--sessions", "2", "--codec", "zlib",
                   "--policy", "single", "--transport", "socket",
                   "--device", "cpu", "--report", str(report)])
    got = json.loads(report.read_text())
    assert got["transport"] == want["transport"] == "socket"
    assert got["decisions"] == want["decisions"]
    assert got["migrations"] == want["migrations"] > 0
    assert got["wire_frames"] == want["wire_frames"]
    assert [e[:3] for e in port_log] == [e[:3] for e in ref_log]
    assert [[m["src"], m["dst"], m["names"]] for m in got["migration_log"]] \
        == [[s, d, list(n)] for s, d, n, _ in ref_log]
    extra = len("repro_torch") - len("repro")
    for (_, _, names, g), (_, _, _, w) in zip(port_log, ref_log):
        assert g - w == (extra if "gray" in names else 0), names
    shipped = sum(extra for e in port_log if "gray" in e[2])
    assert shipped > 0
    assert got["migrated_bytes"] - want["migrated_bytes"] == shipped
    # the modeled transfer time follows the bytes (default 1e9 B/s)
    assert got["modeled_seconds"] == pytest.approx(
        want["modeled_seconds"] + shipped / 1e9, rel=1e-12)


def test_socket_launcher_refuses_a_cuda_device_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "nb.ipynb"
    path.write_text(json.dumps({"nbformat": 4, "nbformat_minor": 5,
                                "metadata": {}, "cells": []}))
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.run_notebook(str(path), sessions=1, transport="socket")


# ----------------------------------------------------------------------
# without jax
# ----------------------------------------------------------------------

_ISOLATED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["ml_dtypes"] = None
import numpy as np
import repro_torch.core as core
from repro_torch import figures
from repro_torch.core import (EnvironmentRegistry, EventLoop, MigrationEngine,
                              SessionReplicaSet, StateReducer, attach_peer,
                              simulate, synthetic_loops_trace)
out = {}
for kind in ("loopback", "socket"):
    reg = EnvironmentRegistry.two_env()
    red = StateReducer(codec="zlib", device="cpu")
    eng = MigrationEngine(red, registry=reg)
    peer = attach_peer(reg["remote"], red, kind=kind)
    reg["local"].state.ns["x"] = np.arange(1000, dtype=np.float32)
    res = eng.migrate(reg["local"], reg["remote"], "y = x.sum()")
    reg["remote"].execute("y = float(x.sum())")
    home = eng.migrate(reg["remote"], reg["local"], names={"y"})
    peer.close()
    reg["remote"]._server.join(10.0)
    out[kind] = (res.transport, res.names, home.names,
                 reg["local"].state.ns["y"])
loop = EventLoop()
fired = []
loop.call_later(1.0, lambda: fired.append(loop.now()))
loop.run()
tr = synthetic_loops_trace()
blk = simulate(tr, "block", migration_time=1.0, remote_speedup=50)
rows = figures.run(smoke=True)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(repr((out, fired, blk.migrations > 0, len(rows), loaded)))
"""


def test_the_transport_plane_runs_without_jax():
    env = {k: os.environ[k] for k in ("HOME", "TMPDIR", "PATH")
           if k in os.environ}
    out = subprocess.run([sys.executable, "-c", _ISOLATED],
                         capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    got, fired, migrated, n_rows, loaded = eval(out.stdout.strip())  # noqa: S307
    for kind in ("loopback", "socket"):
        assert got[kind] == (kind, ("x",), ("y",), 499500.0)
    assert fired == [1.0] and migrated and n_rows > 0
    assert loaded == []
