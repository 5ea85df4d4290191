"""Pluggable transports: how migration frames actually move.

The wire format (:mod:`repro_torch.core.wire`) says what the bytes *are*; a
:class:`Transport` says how they *travel*:

- :class:`LoopbackTransport` — in-process, zero-copy: ``Frame`` objects
  pass through a queue without ever being encoded.  This is the default
  semantics of the engine's direct path (simulated timing, bit-identical
  paper decisions); the explicit transport exists so the full protocol can
  be exercised and benchmarked without a socket.
- :class:`SocketTransport` — real TCP.  Frames are CRC-framed on the way
  out and integrity-checked on the way in; an optional :class:`TokenBucket`
  shapes bandwidth/latency so wall-clock benchmark numbers stay controlled.
- :class:`SubprocessEnv` — an :class:`~repro_torch.core.fabric.ExecutionEnvironment`
  whose namespace lives in a *child Python process*, reached over a
  SocketTransport: migrations stream chunks into the child's store, cells
  execute there for real, and results round-trip home.

**Timing composition**: the engine always charges the *modeled* link
seconds on the simulated clock (that is what placement decisions are made
from, and what keeps fig5/fig11 bit-identical); a real transport
additionally records measured wall seconds and frame counts on the
:class:`~repro_torch.core.migration.MigrationResult`.
"""
from __future__ import annotations

import os
import queue
import select
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core import wire
from repro_torch.core.state import ExecutionState
from repro_torch.core.wire import Frame, FrameDecoder, WireError

TRANSPORTS = ("loopback", "socket", "subprocess")

_RECV_TIMEOUT = 60.0        # a wedged peer must fail, not hang the session


# ----------------------------------------------------------------------
# shaping
# ----------------------------------------------------------------------

class TokenBucket:
    """Classic token bucket: ``delay(n)`` returns how long the caller must
    sleep before putting ``n`` more bytes on the wire, plus a fixed per-call
    latency.  A monotonic clock is injectable so the math is unit-testable
    without sleeping."""

    def __init__(self, rate: float, *, burst: int = 1 << 16,
                 latency: float = 0.0, clock=time.monotonic):
        assert rate > 0, "shaping rate must be positive bytes/second"
        self.rate = float(rate)
        self.burst = float(burst)
        self.latency = float(latency)
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()

    def delay(self, nbytes: int, *, low_priority: bool = False) -> float:
        """Two priority classes share the one bucket without starvation:

        * the **interactive** lane (default) may drive the bucket negative —
          its frame goes out after at most its own serialization time;
        * the **low** lane (trickle traffic) must *wait out* its whole
          deficit first and never leaves the bucket below zero, so an
          interactive frame arriving right behind a trickle frame sees a
          non-negative bucket and is delayed by no more than one in-flight
          frame's serialization — trickle can never starve it.

        Low frames are delayed, never starved: the refill guarantees each
        one eventually clears its deficit.
        """
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now
        if low_priority:
            if self._tokens >= nbytes:
                self._tokens -= nbytes
                return self.latency
            wait = (nbytes - self._tokens) / self.rate
            self._tokens = 0.0
            return wait + self.latency
        self._tokens -= nbytes
        wait = 0.0 if self._tokens >= 0 else -self._tokens / self.rate
        return wait + self.latency


# ----------------------------------------------------------------------
# transports
# ----------------------------------------------------------------------

class Transport:
    """Bidirectional, ordered, reliable frame pipe."""

    kind = "abstract"

    def __init__(self):
        self.frames_sent = 0
        self.bytes_sent = 0
        self.frames_recv = 0
        self.bytes_recv = 0

    def send(self, frame: Frame, *, low_priority: bool = False) -> int:
        raise NotImplementedError

    def recv(self, timeout: float | None = _RECV_TIMEOUT) -> Frame:
        raise NotImplementedError

    def poll(self) -> Frame | None:
        """Non-blocking receive: a complete frame if one is available right
        now, else ``None``.  Lets an event loop service many transports
        from one timer tick without dedicating a blocked thread to each."""
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class LoopbackTransport(Transport):
    """Zero-copy in-process transport: ``Frame`` objects cross a thread-safe
    queue without encoding; ``bytes_sent`` still accounts what the frame
    *would* cost on a real link (``Frame.wire_size``)."""

    kind = "loopback"

    def __init__(self, out_q: "queue.Queue[Frame]", in_q: "queue.Queue[Frame]"):
        super().__init__()
        self._out = out_q
        self._in = in_q
        self._closed = False

    @classmethod
    def pair(cls) -> tuple["LoopbackTransport", "LoopbackTransport"]:
        a_to_b: queue.Queue[Frame] = queue.Queue()
        b_to_a: queue.Queue[Frame] = queue.Queue()
        return cls(a_to_b, b_to_a), cls(b_to_a, a_to_b)

    def send(self, frame: Frame, *, low_priority: bool = False) -> int:
        if self._closed:
            raise WireError("send on closed loopback transport")
        self._out.put(frame)
        self.frames_sent += 1
        self.bytes_sent += frame.wire_size
        return frame.wire_size

    def recv(self, timeout: float | None = _RECV_TIMEOUT) -> Frame:
        try:
            frame = self._in.get(timeout=timeout)
        except queue.Empty:
            raise WireError("loopback recv timed out") from None
        self.frames_recv += 1
        self.bytes_recv += frame.wire_size
        return frame

    def poll(self) -> Frame | None:
        try:
            frame = self._in.get_nowait()
        except queue.Empty:
            return None
        self.frames_recv += 1
        self.bytes_recv += frame.wire_size
        return frame

    def close(self) -> None:
        self._closed = True


def sendmsg_all(sock: socket.socket, segments: list) -> int:
    """writev-style gathered send: push every segment without ever joining
    them into one buffer (``socket.sendmsg`` takes the list directly).
    Handles partial sends by re-gathering the unsent tail as views."""
    total = sum(len(s) for s in segments)
    segs = [s if isinstance(s, memoryview) else memoryview(s)
            for s in segments]
    sent_total = 0
    while segs:
        sent = sock.sendmsg(segs)
        sent_total += sent
        if sent_total >= total:
            break
        while sent:                      # drop/trim fully/partly sent heads
            if sent >= len(segs[0]):
                sent -= len(segs[0])
                segs.pop(0)
            else:
                segs[0] = segs[0][sent:]
                sent = 0
    return total


class SocketTransport(Transport):
    """Real TCP.  Outbound frames are encoded scatter-gather (length
    prefix, payload part(s), CRC go out as one ``sendmsg`` — chunk payloads
    are never copied into a joined buffer); inbound bytes run through the
    incremental :class:`FrameDecoder`, so corruption and truncation surface
    as :class:`WireError`.  ``shaper`` throttles outbound bytes (token
    bucket + fixed latency)."""

    kind = "socket"

    def __init__(self, sock: socket.socket, *,
                 shaper: TokenBucket | None = None):
        super().__init__()
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover - e.g. AF_UNIX
            pass
        self.shaper = shaper
        self._dec = FrameDecoder()
        self._closed = False

    @classmethod
    def connect(cls, host: str, port: int, *, timeout: float = 10.0,
                shaper: TokenBucket | None = None) -> "SocketTransport":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        return cls(sock, shaper=shaper)

    def send(self, frame: Frame, *, low_priority: bool = False) -> int:
        segments = frame.segments()
        nbytes = sum(len(s) for s in segments)
        if self.shaper is not None:
            wait = self.shaper.delay(nbytes, low_priority=low_priority)
            if wait > 0:
                time.sleep(wait)
        try:
            sendmsg_all(self._sock, segments)
        except OSError as e:
            raise WireError(f"socket send failed: {e}") from None
        self.frames_sent += 1
        self.bytes_sent += nbytes
        return nbytes

    def recv(self, timeout: float | None = _RECV_TIMEOUT) -> Frame:
        for f in self._dec.frames():
            self.frames_recv += 1
            self.bytes_recv += f.wire_size
            return f
        self._sock.settimeout(timeout)
        while True:
            try:
                data = self._sock.recv(1 << 16)
            except socket.timeout:
                raise WireError("socket recv timed out") from None
            except OSError as e:
                raise WireError(f"socket recv failed: {e}") from None
            if not data:
                raise WireError("peer closed the connection mid-stream")
            self._dec.feed(data)
            for f in self._dec.frames():
                self.frames_recv += 1
                self.bytes_recv += f.wire_size
                return f

    def poll(self) -> Frame | None:
        while True:
            for f in self._dec.frames():
                self.frames_recv += 1
                self.bytes_recv += f.wire_size
                return f
            ready, _, _ = select.select([self._sock], [], [], 0)
            if not ready:
                return None
            try:
                data = self._sock.recv(1 << 16)
            except OSError as e:
                raise WireError(f"socket recv failed: {e}") from None
            if not data:
                raise WireError("peer closed the connection mid-stream")
            self._dec.feed(data)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# ----------------------------------------------------------------------
# receiver state machine (the server half, shared by the in-process
# EnvServer thread and the subprocess worker)
# ----------------------------------------------------------------------

def import_alias_specs(ns: dict, specs) -> None:
    """Apply ``"alias=module"`` manifest specs: import each module into
    ``ns`` under its alias (missing modules are skipped — parity with the
    loopback path's best-effort re-import)."""
    import importlib
    for spec in specs:
        alias, _, target = spec.partition("=")
        try:
            ns[alias] = importlib.import_module(target or alias)
        except ImportError:
            pass


def serve_receiver(receiver: "WireReceiver", transport: Transport,
                   timeout: float | None = _RECV_TIMEOUT) -> Exception | None:
    """Drive a receiver until BYE or disconnect.  Framing breaches
    (WireError) end the session and are returned; any *other* receiver
    exception — a failed deserialize, a poisoned unpickle — is reported to
    the sender as an ERROR frame and the receiver keeps serving (the
    sender's pending ack turns into a prompt WireError instead of a
    timeout)."""
    try:
        while True:
            frame = transport.recv(timeout=timeout)
            try:
                if not receiver.handle(frame, transport):
                    return None
            except WireError:
                raise
            except Exception as e:  # noqa: BLE001 — travels back as ERROR
                receiver._pending = None
                receiver._pending_chunks = {}
                transport.send(wire.json_frame(wire.ERROR, {
                    "error": f"{type(e).__name__}: {e}", "kind": "receiver"}))
    except WireError as e:
        return e


class WireReceiver:
    """Applies an inbound frame stream to a chunk store + namespace, and
    serves the pull/exec RPCs.  One receiver per connection; drive it with
    :func:`serve_receiver` (blocking loop) or frame-by-frame via
    :meth:`handle`."""

    def __init__(self, chunk_store, reducer, ns: dict | None = None):
        self.store = chunk_store
        self.reducer = reducer
        self.state = ExecutionState()
        if ns is not None:
            self.state.ns = ns       # share, don't copy: the env's namespace
                                     # IS the receiver's namespace
        self._pending = None          # (ser, deleted, modules, banked-only)
        self._pending_chunks: dict[int, bytes] = {}
        self._pending_trickle = False
        self.streams_applied = 0
        self.streams_cancelled = 0
        self.streams_trickled = 0
        # replica plane: convergence watermark this namespace has applied
        # (commit sequence of the last REPLICA stream that fully landed)
        self.replica_epoch = 0
        self._replica_pending_epoch: int | None = None
        self.replicas_applied = 0
        self.promotions = 0
        # first-result-wins racing: ids whose CANCEL already arrived — a
        # late "run" for a cancelled race must NOT execute (the wire-level
        # guarantee that a lost race cannot clobber committed state)
        self._races_cancelled: set[str] = set()
        self.races_run = 0
        self.races_cancelled = 0

    # -- helpers --------------------------------------------------------
    def _apply_pending(self) -> list[str]:
        ser, deleted, modules, _spec = self._pending
        ser.chunks = self._pending_chunks
        import_alias_specs(self.state.ns, modules)
        objs = self.reducer.deserialize(ser, target_ns=self.state.ns,
                                        chunk_store=self.store)
        self.state.update(objs)
        self.state.drop(deleted)
        self.streams_applied += 1
        return sorted(objs)

    # -- the state machine ----------------------------------------------
    def handle(self, frame: Frame, transport: Transport) -> bool:
        """Process one frame; returns False when the session should end."""
        t = frame.ftype
        if t == wire.HELLO:
            wire.parse_hello(frame)                 # validates magic/version
            transport.send(wire.hello_frame(self.reducer.codec))
        elif t == wire.MANIFEST:
            ser, deleted, modules, spec, trickle = wire.parse_manifest(frame)
            # a trickle stream banks exactly like a speculative one: chunks
            # land in the store, the namespace waits for a claiming stream
            self._pending = (ser, deleted, modules, spec or trickle)
            self._pending_trickle = trickle
            if trickle:
                self.streams_trickled += 1
            self._pending_chunks = {}
            referenced = {d for b in ser.blobs.values()
                          for d in b.chunk_digests()}
            need = sorted(d for d in referenced if not self.store.has(d))
            transport.send(wire.json_frame(wire.ACK, {"need": need}))
        elif t == wire.CHUNK:
            digest = self.store.ingest_frame(frame)
            self._pending_chunks[digest] = self.store.get(digest)
        elif t == wire.TOMBSTONE:
            self.state.drop(parse_list(frame))
        elif t == wire.END:
            if self._pending is None:
                raise WireError("END without a preceding MANIFEST")
            spec = self._pending[3]
            applied: list[str] = []
            if not spec:
                # speculative/trickle streams only bank chunks; the
                # namespace is touched when the claiming stream lands
                applied = self._apply_pending()
            self._pending = None
            self._pending_chunks = {}
            ack_doc: dict = {"applied": applied, "speculative": spec}
            if self._pending_trickle:
                ack_doc["trickle"] = True
            self._pending_trickle = False
            if self._replica_pending_epoch is not None:
                # the convergence delta fully landed: advance the watermark
                self.replica_epoch = self._replica_pending_epoch
                self._replica_pending_epoch = None
                self.replicas_applied += 1
            transport.send(wire.json_frame(wire.ACK, ack_doc))
        elif t == wire.CANCEL:
            # in-flight cancellation: the stream's chunks stay banked
            # (content-addressed, immutable) but nothing touches the
            # namespace and no ack is owed
            if self._pending is not None:
                self.streams_cancelled += 1
            self._pending = None
            self._pending_chunks = {}
            self._pending_trickle = False
            self._replica_pending_epoch = None
        elif t == wire.EXEC:
            req = wire.parse_json(frame)
            t0 = time.perf_counter()
            try:
                exec(compile(req["source"], "<remote>", "exec"),  # noqa: S102
                     self.state.ns)
            except Exception as e:  # noqa: BLE001 — travels back as RESULT
                transport.send(wire.json_frame(
                    wire.RESULT, {"error": f"{type(e).__name__}: {e}"}))
                return True
            transport.send(wire.json_frame(
                wire.RESULT, {"duration": time.perf_counter() - t0}))
        elif t == wire.REPLICA:
            # convergence-delta header: drop the announced tombstones now
            # (mid-stream deletions converge even when the residual delta
            # is empty) and stage the watermark — committed at END, so a
            # cancelled stream never overstates convergence
            doc = wire.parse_replica(frame)
            self.state.drop(doc["deleted"])
            self._replica_pending_epoch = doc["epoch"]
        elif t == wire.PROMOTE:
            # failover handshake: reply with the watermark this namespace
            # actually converged to — a stale promoter learns the residual
            _session, _epoch = wire.parse_promote(frame)
            self.promotions += 1
            transport.send(wire.json_frame(
                wire.RESULT, {"epoch": self.replica_epoch}))
        elif t == wire.RACE:
            doc = wire.parse_race(frame)
            if doc["action"] == "cancel":
                self._races_cancelled.add(doc["id"])
                self.races_cancelled += 1
            elif doc["id"] in self._races_cancelled:
                # the CANCEL raced ahead of the run: do NOT execute — a
                # lost race must never touch this namespace
                transport.send(wire.json_frame(
                    wire.RESULT, {"id": doc["id"], "cancelled": True}))
            else:
                # a race leg runs against an OVERLAY of the namespace and
                # the overlay is discarded: only the committing (winner)
                # path — a normal EXEC/migration — mutates real state, so
                # the committed result is bit-identical to a solo run
                self.races_run += 1
                overlay = dict(self.state.ns)
                t0 = time.perf_counter()
                try:
                    exec(compile(doc["source"], "<race>", "exec"),  # noqa: S102
                         overlay)
                except Exception as e:  # noqa: BLE001 — back as RESULT
                    transport.send(wire.json_frame(wire.RESULT, {
                        "id": doc["id"],
                        "error": f"{type(e).__name__}: {e}"}))
                    return True
                transport.send(wire.json_frame(wire.RESULT, {
                    "id": doc["id"],
                    "duration": time.perf_counter() - t0}))
        elif t == wire.FETCH:
            self._serve_fetch(wire.parse_json(frame), transport)
        elif t == wire.BYE:
            return False
        elif t == wire.ERROR:
            doc = wire.parse_json(frame)
            raise WireError(f"peer error: {doc.get('error')}")
        else:  # pragma: no cover - decoder rejects unknown types first
            raise WireError(f"unexpected frame type {t}")
        return True

    def _serve_fetch(self, req: dict, transport: Transport) -> None:
        """The pull path: this side becomes the sender of a state stream."""
        import types as _types
        from repro_torch.core.reducer import SerializationFailure
        names = req.get("names")
        source = req.get("source")
        known = {n: int(d) for n, d in (req.get("known") or {}).items()}
        modules: set[str] = set()
        if names is None:
            if source:
                names, modules, _ = self.reducer.reduce(self.state, source)
            else:
                names = set(self.state.names())
        names = {n for n in names if n in self.state.ns
                 and not isinstance(self.state.get(n), _types.ModuleType)}
        mod_aliases = [
            f"{alias}={val.__name__}" for alias, val in self.state.ns.items()
            if isinstance(val, _types.ModuleType)
            and (alias in (req.get("names") or (alias,))
                 or val.__name__.split(".")[0] in modules)
            and not alias.startswith("__")]
        if req.get("delta", True):
            send, dead, here = self.reducer.delta_names(self.state, names,
                                                        known)
            send &= names
        else:
            send, dead, here = set(names), set(), None
        try:
            ser = self.reducer.serialize_names(
                self.state, send,
                on_error="raise" if req.get("strict", True) else "skip",
                digests=here)
        except SerializationFailure as e:
            transport.send(wire.json_frame(
                wire.ERROR, {"error": str(e), "kind": "serialization"}))
            return
        transport.send(wire.manifest_frame(ser, deleted=dead,
                                           modules=mod_aliases))
        ack = wire.parse_json(_expect(transport.recv(), wire.ACK))
        need = [int(d) for d in ack.get("need", [])]
        for f in wire.state_stream_frames(ser, need, deleted=dead):
            transport.send(f)
        _expect(transport.recv(), wire.ACK)           # done-ack


def parse_list(frame: Frame) -> list[str]:
    doc = wire.parse_json(frame)
    if not isinstance(doc, list):
        raise WireError(f"expected a JSON list payload, got {type(doc)}")
    return [str(x) for x in doc]


def _expect(frame: Frame, ftype: int) -> Frame:
    if frame.ftype == wire.ERROR:
        doc = wire.parse_json(frame)
        if doc.get("kind") == "serialization":
            from repro_torch.core.reducer import SerializationFailure
            raise SerializationFailure(doc.get("error", "remote"))
        raise WireError(f"peer error: {doc.get('error')}")
    if frame.ftype != ftype:
        raise WireError(f"expected {wire.TYPE_NAMES[ftype]}, got "
                        f"{wire.TYPE_NAMES.get(frame.ftype, frame.ftype)}")
    return frame


# ----------------------------------------------------------------------
# sender peer (the client half the MigrationEngine drives)
# ----------------------------------------------------------------------

@dataclass
class StreamStats:
    """What one state stream actually cost on the transport."""
    frames: int = 0
    wire_bytes: int = 0
    wall_seconds: float = 0.0
    held: set = field(default_factory=set)


class MigrationPeer:
    """Sender-side protocol driver bound to one remote environment.  The
    engine calls :meth:`send_state` (push), :meth:`fetch_state` (pull),
    :meth:`execute` (run a cell remotely) and :meth:`cancel` (abort an
    in-flight speculative stream)."""

    def __init__(self, transport: Transport, *, codec: str = "zlib",
                 handshake: bool = True):
        self.transport = transport
        self.codec = codec
        self._lock = threading.Lock()
        self._closed = False
        if handshake:
            transport.send(wire.hello_frame(codec))
            wire.parse_hello(_expect(transport.recv(), wire.HELLO))

    # -- push -----------------------------------------------------------
    def send_state(self, ser, *, deleted=(), modules=(),
                   speculative: bool = False, trickle: bool = False,
                   low_priority: bool = False) -> StreamStats:
        """One full state stream: MANIFEST, need-ack, CHUNKs, TOMBSTONE,
        END, done-ack.  Returns the held set (chunks the receiver did NOT
        request) plus real frame/byte/wall accounting.  ``trickle`` marks
        a background-replication stream (banked like a speculative one);
        ``low_priority`` puts every frame on the shaper's low lane so
        interactive traffic always preempts it."""
        tr = self.transport
        t0 = time.perf_counter()
        with self._lock:
            sent0, bytes0 = tr.frames_sent, tr.bytes_sent
            tr.send(wire.manifest_frame(ser, deleted=deleted, modules=modules,
                                        speculative=speculative,
                                        trickle=trickle),
                    low_priority=low_priority)
            ack = wire.parse_json(_expect(tr.recv(), wire.ACK))
            need = [int(d) for d in ack.get("need", [])]
            for f in wire.state_stream_frames(ser, need, deleted=deleted):
                tr.send(f, low_priority=low_priority)
            _expect(tr.recv(), wire.ACK)
            referenced = {d for b in ser.blobs.values()
                          for d in b.chunk_digests()}
            return StreamStats(
                frames=tr.frames_sent - sent0,
                wire_bytes=tr.bytes_sent - bytes0,
                wall_seconds=time.perf_counter() - t0,
                held=referenced - set(need))

    # -- pull -----------------------------------------------------------
    def fetch_state(self, *, names=None, cell_source: str | None = None,
                    known: dict[str, int] | None = None, strict: bool = True,
                    delta: bool = True, store=None):
        """Ask the remote side to send a state stream; chunks the local
        ``store`` already holds are not re-requested.  Returns
        (SerializedState, deleted, modules, StreamStats)."""
        tr = self.transport
        t0 = time.perf_counter()
        with self._lock:
            sent0, bytes0 = tr.frames_recv, tr.bytes_recv
            tr.send(wire.json_frame(wire.FETCH, {
                "names": sorted(names) if names is not None else None,
                "source": cell_source, "known": known or {},
                "strict": strict, "delta": delta}))
            ser, deleted, modules, _spec, _trickle = wire.parse_manifest(
                _expect(tr.recv(), wire.MANIFEST))
            referenced = {d for b in ser.blobs.values()
                          for d in b.chunk_digests()}
            need = sorted(d for d in referenced
                          if store is None or not store.has(d))
            tr.send(wire.json_frame(wire.ACK, {"need": need}))
            chunks: dict[int, bytes] = {}
            dead: tuple[str, ...] = deleted
            while True:
                f = tr.recv()
                if f.ftype == wire.CHUNK:
                    d, enc = wire.parse_chunk(f)
                    # chunks outlive the recv loop: own the bytes here so a
                    # small chunk view cannot pin a whole recv buffer
                    chunks[d] = enc if isinstance(enc, bytes) else bytes(enc)
                elif f.ftype == wire.TOMBSTONE:
                    dead = tuple(parse_list(f))
                elif f.ftype == wire.END:
                    break
                else:
                    _expect(f, wire.END)    # raises with a useful message
            tr.send(wire.json_frame(wire.ACK, {"applied": sorted(ser.blobs)}))
            ser.chunks = chunks
            stats = StreamStats(frames=tr.frames_recv - sent0,
                                wire_bytes=tr.bytes_recv - bytes0,
                                wall_seconds=time.perf_counter() - t0,
                                held=referenced - set(need))
            return ser, dead, modules, stats

    # -- exec rpc --------------------------------------------------------
    def execute(self, source: str) -> float:
        """Run ``source`` in the remote namespace; returns remote wall
        seconds.  Remote exceptions re-raise here as RuntimeError."""
        with self._lock:
            self.transport.send(wire.json_frame(wire.EXEC, {"source": source}))
            doc = wire.parse_json(_expect(self.transport.recv(), wire.RESULT))
        if "error" in doc:
            raise RuntimeError(f"remote execution failed: {doc['error']}")
        return float(doc["duration"])

    def cancel(self) -> None:
        """Send a CANCEL frame: the receiver drops any in-flight stream
        state.  With this peer's synchronous ``send_state`` the speculative
        stream has already fully landed by the time a stale claim cancels
        it, so CANCEL is a no-op safety net here — it exists for (and is
        exercised by) receivers whose sender died mid-stream, and for
        future transports that stream asynchronously."""
        with self._lock:
            self.transport.send(Frame(wire.CANCEL))

    # -- replica plane ---------------------------------------------------
    def replicate(self, session: str, epoch: int, ser, *,
                  deleted=()) -> StreamStats:
        """Ship a convergence delta: a REPLICA header (session, commit
        epoch, tombstones) followed by a normal non-speculative state
        stream the receiver *applies* — the remote watermark advances when
        the stream's END lands."""
        with self._lock:
            self.transport.send(wire.replica_frame(session, epoch,
                                                   deleted=deleted))
        return self.send_state(ser)

    def promote(self, session: str, epoch: int) -> int:
        """Failover handshake: returns the follower's own convergence
        watermark (authoritative — a stale promoter learns the residual)."""
        with self._lock:
            self.transport.send(wire.promote_frame(session, epoch))
            doc = wire.parse_json(_expect(self.transport.recv(), wire.RESULT))
        return int(doc.get("epoch", 0))

    def race(self, race_id: str, source: str) -> int:
        """Launch the losing-capable leg of a first-result-wins race; the
        remote side executes against a discarded overlay and replies with a
        RESULT tagged by the race id (or ``cancelled`` when the CANCEL got
        there first).  Returns the wire bytes the leg cost."""
        with self._lock:
            sent0 = self.transport.bytes_sent
            self.transport.send(wire.race_frame(race_id, "run", source))
            wire.parse_json(_expect(self.transport.recv(), wire.RESULT))
            return self.transport.bytes_sent - sent0

    def race_cancel(self, race_id: str) -> None:
        """The other leg won (or the race was aborted): a late ``run`` for
        this id must not execute on the remote side."""
        with self._lock:
            self.transport.send(wire.race_frame(race_id, "cancel"))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            with self._lock:
                self.transport.send(Frame(wire.BYE))
        except WireError:
            pass
        self.transport.close()


# ----------------------------------------------------------------------
# serving an in-process environment (socket or loopback)
# ----------------------------------------------------------------------

class EnvServer:
    """Background thread running a :class:`WireReceiver` bound to an
    environment's chunk store + namespace.  Lets the engine drive the real
    frame protocol against an env living in this very process — the
    'socket' rows of ``bench_transport`` and the transport tests."""

    def __init__(self, env, reducer, transport: Transport):
        self.env = env
        self.receiver = WireReceiver(env.chunk_store, reducer,
                                     ns=env.state.ns)
        self.transport = transport
        self.error: Exception | None = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"envserver-{env.name}")
        self.thread.start()

    def _run(self) -> None:
        try:
            self.error = serve_receiver(self.receiver, self.transport)
        finally:
            self.transport.close()

    def join(self, timeout: float = 5.0) -> None:
        self.thread.join(timeout)


def attach_peer(env, reducer, *, kind: str = "socket",
                shaper: TokenBucket | None = None) -> MigrationPeer:
    """Bind a live transport to ``env``: frames now genuinely carry its
    migration traffic (socket = real TCP through localhost; loopback =
    zero-copy queues).  Sets ``env.peer`` (the engine's hook) and
    ``env.transport``; returns the peer (close it to tear down)."""
    if kind == "socket":
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        client = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        conn, _addr = srv.accept()
        srv.close()
        server_tr = SocketTransport(conn)
        client_tr = SocketTransport(client, shaper=shaper)
    elif kind == "loopback":
        client_tr, server_tr = LoopbackTransport.pair()
    else:
        raise ValueError(f"unknown transport kind {kind!r} "
                         f"(expected socket|loopback)")
    env._server = EnvServer(env, reducer, server_tr)
    peer = MigrationPeer(client_tr, codec=reducer.codec)
    env.peer = peer
    env.transport = kind
    return peer


# ----------------------------------------------------------------------
# stream multiplexing: N sessions on ONE socket
# ----------------------------------------------------------------------

class MuxStream(Transport):
    """One virtual frame pipe inside a :class:`MuxPeer`.  Implements the
    full Transport interface, so a :class:`MigrationPeer` (or anything
    else that talks frames) binds to it unchanged.

    Byte accounting counts the *inner* frame's wire size — exactly what
    the same traffic would cost on a dedicated connection — so per-stream
    counters are directly comparable to (and must equal) a one-socket-per-
    session deployment's.  The envelope overhead (9-byte STREAM header +
    CRC + 4-byte stream id per frame) lives on the underlying transport's
    counters, where the sharing actually happens."""

    kind = "mux"

    def __init__(self, peer: "MuxPeer", sid: int, *,
                 bucket: TokenBucket | None = None,
                 low_priority: bool = False):
        super().__init__()
        self.peer = peer
        self.sid = sid
        self.bucket = bucket          # per-stream flow control (optional)
        self.low_priority = low_priority
        self._closed = False

    def send(self, frame: Frame, *, low_priority: bool = False) -> int:
        if self._closed:
            raise WireError(f"send on closed mux stream {self.sid}")
        self.peer._send(self.sid, frame,
                        low_priority=low_priority or self.low_priority,
                        bucket=self.bucket)
        self.frames_sent += 1
        self.bytes_sent += frame.wire_size
        return frame.wire_size

    def recv(self, timeout: float | None = _RECV_TIMEOUT) -> Frame:
        frame = self.peer._recv(self.sid, timeout)
        self.frames_recv += 1
        self.bytes_recv += frame.wire_size
        return frame

    def poll(self) -> Frame | None:
        frame = self.peer._poll(self.sid)
        if frame is not None:
            self.frames_recv += 1
            self.bytes_recv += frame.wire_size
        return frame

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.peer._close_stream(self.sid)


class MuxPeer:
    """Stream-id multiplexing over one underlying transport: each frame
    rides a STREAM envelope (u32 stream id + the complete inner frame),
    and any number of :class:`MuxStream` handles share the connection.

    * **send** is serialized on one lock; a per-stream
      :class:`TokenBucket` (``open_stream(rate=...)``) shapes that
      stream's bytes *before* the lock so one throttled stream never
      blocks the others, and ``low_priority`` streams ride the underlying
      shaper's trickle lane.
    * **recv** is demultiplexed cooperatively: whichever thread needs a
      frame pumps the shared connection (one pumper at a time) and routes
      inbound frames to per-stream inboxes; everyone else waits on their
      inbox.  Streams the remote side opened first surface through
      :meth:`accept_stream`.

    The two ends split the stream-id space odd/even (``initiator=True``
    allocates odd ids) so both may open streams without collision."""

    def __init__(self, transport: Transport, *, initiator: bool = True):
        self.transport = transport
        self._send_lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._inboxes: dict[int, queue.Queue] = {}
        self._accept_q: "queue.Queue[int]" = queue.Queue()
        self._next_sid = 1 if initiator else 2

    # -- stream lifecycle ------------------------------------------------
    def open_stream(self, *, rate: float | None = None, burst: int = 1 << 16,
                    low_priority: bool = False,
                    clock=time.monotonic) -> MuxStream:
        with self._state_lock:
            sid = self._next_sid
            self._next_sid += 2
            self._inboxes.setdefault(sid, queue.Queue())
        bucket = (TokenBucket(rate, burst=burst, clock=clock)
                  if rate else None)
        return MuxStream(self, sid, bucket=bucket, low_priority=low_priority)

    def accept_stream(self, timeout: float | None = _RECV_TIMEOUT,
                      **stream_kw) -> MuxStream:
        """A stream the remote end opened: surfaces when its first frame
        arrives (there is no explicit open handshake — the id is the
        stream)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                sid = self._accept_q.get_nowait()
                return MuxStream(self, sid, **stream_kw)
            except queue.Empty:
                pass
            self._pump(deadline, lambda: not self._accept_q.empty())

    def _close_stream(self, sid: int) -> None:
        with self._state_lock:
            self._inboxes.pop(sid, None)

    def close(self) -> None:
        self.transport.close()

    # -- send ------------------------------------------------------------
    def _send(self, sid: int, frame: Frame, *, low_priority: bool,
              bucket: TokenBucket | None) -> None:
        if bucket is not None:
            # per-stream shaping happens OUTSIDE the shared send lock: a
            # throttled stream sleeps on its own time, not the socket's
            wait = bucket.delay(frame.wire_size, low_priority=low_priority)
            if wait > 0:
                time.sleep(wait)
        env = wire.stream_frame(sid, frame)
        with self._send_lock:
            self.transport.send(env, low_priority=low_priority)

    # -- recv ------------------------------------------------------------
    def _route(self, frame: Frame) -> None:
        sid, inner = wire.parse_stream(frame)
        with self._state_lock:
            box = self._inboxes.get(sid)
            if box is None:
                box = self._inboxes[sid] = queue.Queue()
                self._accept_q.put(sid)
        box.put(inner)

    def _pump(self, deadline: float | None, done) -> None:
        """Pump the shared connection until ``done()`` or the deadline.
        Only one thread pumps at a time; the rest sleep briefly on their
        own inboxes (frames reach them as the pumper routes)."""
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        if self._pump_lock.acquire(timeout=min(remaining, 0.05)
                                   if remaining is not None else 0.05):
            try:
                if done():
                    return
                self._route(self.transport.recv(timeout=remaining))
            finally:
                self._pump_lock.release()
        elif deadline is not None and time.monotonic() >= deadline:
            raise WireError("mux recv timed out waiting for the pump")
        else:
            time.sleep(0.001)

    def _recv(self, sid: int, timeout: float | None) -> Frame:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._state_lock:
                box = self._inboxes.get(sid)
            if box is None:
                raise WireError(f"recv on closed mux stream {sid}")
            try:
                return box.get_nowait()
            except queue.Empty:
                pass
            if deadline is not None and time.monotonic() >= deadline:
                raise WireError(f"mux recv timed out on stream {sid}")
            self._pump(deadline, lambda: not box.empty())

    def _poll(self, sid: int) -> Frame | None:
        with self._state_lock:
            box = self._inboxes.get(sid)
        if box is None:
            raise WireError(f"poll on closed mux stream {sid}")
        try:
            return box.get_nowait()
        except queue.Empty:
            pass
        # drain whatever the underlying transport has ready, then retry
        if self._pump_lock.acquire(blocking=False):
            try:
                while True:
                    f = self.transport.poll()
                    if f is None:
                        break
                    self._route(f)
            finally:
                self._pump_lock.release()
        try:
            return box.get_nowait()
        except queue.Empty:
            return None


class MuxEnvServer:
    """The server half of a multiplexed connection: ONE thread, one
    socket, N receiver state machines — versus :class:`EnvServer`'s
    thread-per-connection.  ``make_receiver(sid)`` builds the
    :class:`WireReceiver` for a stream the first time a frame arrives on
    it; replies ride the same stream.  A BYE inside a stream retires that
    stream's receiver; closing the underlying transport (or an envelope-
    level WireError) ends the whole connection."""

    def __init__(self, transport: Transport, make_receiver,
                 timeout: float | None = _RECV_TIMEOUT,
                 persistent: bool = False):
        self.transport = transport
        self.make_receiver = make_receiver
        self.timeout = timeout
        self.persistent = persistent      # keep serving after the last BYE
        self.error: Exception | None = None
        self.streams_served = 0
        self._receivers: dict[int, WireReceiver] = {}
        self._streams: dict[int, MuxStream] = {}
        self._mux = MuxPeer(transport, initiator=False)
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="mux-envserver")
        self.thread.start()

    def _stream(self, sid: int) -> MuxStream:
        if sid not in self._streams:
            self._streams[sid] = MuxStream(self._mux, sid)
        return self._streams[sid]

    def _run(self) -> None:
        try:
            while True:
                frame = self.transport.recv(timeout=self.timeout)
                sid, inner = wire.parse_stream(frame)
                if sid not in self._receivers:
                    self._receivers[sid] = self.make_receiver(sid)
                    self.streams_served += 1
                stream = self._stream(sid)
                try:
                    if not self._receivers[sid].handle(inner, stream):
                        del self._receivers[sid]      # stream-level BYE
                        if not self._receivers and not self.persistent:
                            return
                except WireError:
                    raise
                except Exception as e:  # noqa: BLE001 — back as ERROR
                    rcv = self._receivers[sid]
                    rcv._pending = None
                    rcv._pending_chunks = {}
                    stream.send(wire.json_frame(wire.ERROR, {
                        "error": f"{type(e).__name__}: {e}",
                        "kind": "receiver"}))
        except WireError as e:
            self.error = e
        finally:
            self.transport.close()

    def join(self, timeout: float = 5.0) -> None:
        self.thread.join(timeout)


# ----------------------------------------------------------------------
# subprocess environment
# ----------------------------------------------------------------------

class DigestMirrorStore:
    """Parent-side view of a remote store: records *which* digests were
    delivered (so manifest exchange and prefetch banking work) without
    keeping a second copy of the bytes."""

    def __init__(self):
        self._digests: set[int] = set()

    def has(self, d: int) -> bool:
        return d in self._digests

    def put(self, d: int, data: bytes = b"") -> None:
        self._digests.add(d)

    def put_many(self, chunks) -> None:
        self._digests.update(chunks)

    def get(self, d: int) -> bytes:
        raise KeyError(f"digest mirror holds no chunk bytes ({d:016x} "
                       f"lives in the remote store)")

    def digests(self) -> set[int]:
        return set(self._digests)

    def __len__(self) -> int:
        return len(self._digests)

    @property
    def nbytes(self) -> int:
        return 0


class SubprocessEnv:
    """A real receiver ExecutionEnvironment in a child Python process.

    The child (``python -m repro_torch.core.remote_worker``) owns the namespace
    and a real chunk store; this handle implements the environment API the
    engine and runtime expect (``execute``, ``state``, ``chunk_store``,
    lifecycle attrs) while every state movement rides SocketTransport
    frames.  ``state`` here is an empty mirror — the truth lives remotely,
    which is exactly what forces the protocol to be honest.  The child's
    reducer runs its digests, chunk keys and quantization on ``device``
    (``"cuda"``, the default, or ``"cpu"``), as the parent's does."""

    kind = "compute"

    def __init__(self, name: str, *, speedup: float = 1.0,
                 codec: str = "zlib", python: str | None = None,
                 shaper: TokenBucket | None = None,
                 spawn_timeout: float = 120.0, device="cuda"):
        self.name = name
        self.speedup = float(speedup)
        self.mesh_ctx = None
        self.storage_dir = None
        self.status = "up"
        self.cold_start = 0.0
        self.idle_timeout = None
        self.ready_at = 0.0
        self.transport = "subprocess"
        self.chunk_store = DigestMirrorStore()
        self.state = ExecutionState({})
        srv = socket.create_server(("127.0.0.1", 0))
        srv.settimeout(spawn_timeout)
        port = srv.getsockname()[1]
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [python or sys.executable, "-m", "repro_torch.core.remote_worker",
             "--connect", f"127.0.0.1:{port}", "--codec", codec,
             "--device", str(device)],
            env=env, stdout=subprocess.DEVNULL)
        try:
            conn, _addr = srv.accept()
        except socket.timeout:
            self.proc.kill()
            raise WireError(
                f"subprocess env {name!r} did not connect back within "
                f"{spawn_timeout}s") from None
        finally:
            srv.close()
        conn.settimeout(None)
        self.peer = MigrationPeer(SocketTransport(conn, shaper=shaper),
                                  codec=codec)

    # -- environment API -------------------------------------------------
    def set_status(self, status: str, *, now: float = 0.0) -> str:
        old, self.status = self.status, status
        return old

    def placeable_now(self) -> bool:
        return self.status in ("up", "provisioning")

    def execute(self, source: str, cost: float | None = None) -> float:
        wall = self.peer.execute(source)
        base = cost if cost is not None else wall
        return base / self.speedup

    def close(self) -> None:
        if self.proc.poll() is None:
            self.peer.close()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self.proc.kill()
                self.proc.wait()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SubprocessEnv({self.name!r}, pid={self.proc.pid})"
