"""Versioned wire format for migration traffic (the transport plane's
bottom half).

Every byte that crosses a real link rides a length-prefixed, CRC-checked
**frame**:

    frame   := u32_le payload_len | u8 type | payload | u32_le crc
    crc     := crc32(type_byte + payload)

A migration is one **state stream** — the same grammar in both directions
(push via ``MANIFEST``-first, pull via ``FETCH``-first):

    session      := HELLO  (both directions, once per connection)
    state-stream := MANIFEST ack(need) CHUNK* [TOMBSTONE] END ack(done)
    exec-rpc     := EXEC RESULT
    pull         := FETCH state-stream     (remote is the sender)
    abort        := CANCEL                 (drop the in-flight stream)

``MANIFEST`` carries the chunk manifest (names, per-name content digests,
array metadata, chunk digest lists, pickle streams) as canonical JSON, so a
byte-for-byte golden vector pins the format.  ``CHUNK`` payloads are the
*store encoding* — 8-byte digest + 1-byte codec tag + compressed body — so a
received chunk frame lands in a :class:`~repro_torch.core.chunkstore.MemoryChunkStore`
verbatim.  ``TOMBSTONE`` propagates deletions.  ``ACK`` closes each half of
the exchange (the receiver advertises which chunks it needs, then confirms
the applied names).

Corruption of any kind — truncation, bit flips in header or payload, an
unknown frame type, an absurd length — surfaces as :class:`WireError`,
never a crash or a silently wrong namespace.

**Zero-copy framing**: frames are scatter-gather.  A :class:`Frame` holds
its payload as one or more buffer *parts* (``payload_parts``) and encodes
to wire segments — header, payload part(s), CRC — without ever joining
them into one ``bytes`` (:meth:`Frame.segments`; the CRC runs zlib's
streaming path over each part).  On the way in, :class:`FrameDecoder`
keeps the fed buffers as a segment queue and yields payloads as
``memoryview`` slices of them — a CHUNK payload that arrived in one
``recv`` is never copied; only the consumer that genuinely needs owned
``bytes`` (e.g. a chunk store) materializes it.
"""
from __future__ import annotations

import base64
import json
import struct
import zlib
from collections import deque
from typing import Iterable, Iterator

MAGIC = b"RWIR"
VERSION = 1

# frame types ----------------------------------------------------------
HELLO = 1        # session header: magic + version + codec + flags
MANIFEST = 2     # chunk manifest for one state stream (canonical JSON)
CHUNK = 3        # u64 digest + store-encoded chunk (codec tag + body)
ACK = 4          # JSON: {"need": [...]} after MANIFEST, {"applied": [...]} after END
TOMBSTONE = 5    # JSON: ["name", ...] deleted on the sender
END = 6          # state stream complete
CANCEL = 7       # abort the in-flight state stream (speculation went stale)
ERROR = 8        # JSON: {"error": str, "kind": str} — remote failure
EXEC = 9         # JSON: {"source": str, "cost": float|null}
RESULT = 10      # JSON: {"duration": float} or {"error": str}
FETCH = 11       # JSON: pull request — the remote becomes the sender
BYE = 12         # close the session
ATTACH = 13      # JSON: gateway session attach request (tenant, notebook)
DETACH = 14      # JSON: {"session": str, "reason": str}
STREAM = 15      # mux envelope: u32_le stream_id + one complete inner frame
REPLICA = 16     # JSON: replica-plane delta header (session, epoch, deleted)
PROMOTE = 17     # JSON: {"session": str, "epoch": int} — failover handshake
RACE = 18        # JSON: {"id": str, "action": "run"|"cancel", "source": str}

FRAME_TYPES = frozenset((HELLO, MANIFEST, CHUNK, ACK, TOMBSTONE, END,
                         CANCEL, ERROR, EXEC, RESULT, FETCH, BYE,
                         ATTACH, DETACH, STREAM, REPLICA, PROMOTE, RACE))
TYPE_NAMES = {HELLO: "HELLO", MANIFEST: "MANIFEST", CHUNK: "CHUNK",
              ACK: "ACK", TOMBSTONE: "TOMBSTONE", END: "END",
              CANCEL: "CANCEL", ERROR: "ERROR", EXEC: "EXEC",
              RESULT: "RESULT", FETCH: "FETCH", BYE: "BYE",
              ATTACH: "ATTACH", DETACH: "DETACH", STREAM: "STREAM",
              REPLICA: "REPLICA", PROMOTE: "PROMOTE", RACE: "RACE"}

_HEADER = struct.Struct("<IB")        # payload_len, frame_type
_CRC = struct.Struct("<I")
FRAME_OVERHEAD = _HEADER.size + _CRC.size          # 9 bytes per frame

# no legitimate frame approaches this: chunks are <= 256 KiB + codec
# overhead, manifests are metadata.  A corrupted length prefix must fail
# fast instead of asking for gigabytes.
MAX_PAYLOAD = 64 << 20


class WireError(Exception):
    """Malformed or corrupted wire traffic (bad CRC, truncation, unknown
    frame type, oversized length, invalid HELLO, undecodable payload)."""


class Frame:
    """One decoded frame.  ``wire_size`` is what it costs on a real link;
    loopback transports pass Frame objects without ever encoding them.

    The payload is held as a tuple of buffer *parts* (bytes or memoryview)
    so senders can frame large chunks without concatenating them; the
    :attr:`payload` property presents them as one buffer (joining lazily —
    and only when more than one part exists)."""

    __slots__ = ("ftype", "_parts", "_joined")

    def __init__(self, ftype: int, payload=b""):
        self.ftype = ftype
        self._parts = payload if isinstance(payload, tuple) else (payload,)
        self._joined = None

    @property
    def payload(self):
        """The payload as a single bytes-like buffer (bytes or memoryview)."""
        if len(self._parts) == 1:
            return self._parts[0]
        if self._joined is None:
            self._joined = b"".join(bytes(p) for p in self._parts)
        return self._joined

    @property
    def payload_parts(self) -> tuple:
        return self._parts

    @property
    def payload_len(self) -> int:
        return sum(len(p) for p in self._parts)

    @property
    def wire_size(self) -> int:
        return FRAME_OVERHEAD + self.payload_len

    def segments(self) -> list:
        """Scatter-gather wire encoding: ``[header, *payload_parts, crc]``
        — no payload bytes are copied; the CRC streams over each part."""
        crc = zlib.crc32(bytes((self.ftype,)))
        for p in self._parts:
            crc = zlib.crc32(p, crc)
        return [_HEADER.pack(self.payload_len, self.ftype),
                *self._parts, _CRC.pack(crc)]

    def encoded(self) -> bytes:
        return b"".join(bytes(s) for s in self.segments())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Frame({TYPE_NAMES.get(self.ftype, self.ftype)}, "
                f"{self.payload_len}B)")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Frame) and other.ftype == self.ftype
                and self.payload == other.payload)


def encode_frame(ftype: int, payload: bytes) -> bytes:
    crc = zlib.crc32(payload, zlib.crc32(bytes((ftype,))))
    return _HEADER.pack(len(payload), ftype) + payload + _CRC.pack(crc)


class FrameDecoder:
    """Incremental frame decoder: feed buffers as they arrive off a socket,
    iterate complete frames.  Every integrity violation is a WireError.

    Fed buffers are *kept*, not copied, in a segment queue; a decoded
    frame's payload is a ``memoryview`` slice into the fed buffer whenever
    the payload arrived within one ``feed`` (always true for
    :func:`decode_frames` and for loopback streams) — only payloads that
    straddle a feed boundary are joined.  Feed ``bytes`` for the zero-copy
    path; mutable buffers (``bytearray``) are defensively copied because
    the caller could mutate them under a live payload view.

    Long-lived connections (a persistent gateway socket) must not pin
    every buffer they ever received: fully-consumed segments are dropped
    as frames decode, and when the consumed prefix of the head segment
    comes to dominate it the remainder is compacted into a fresh buffer
    (amortized O(1) per byte), so :attr:`retained_bytes` stays
    O(unconsumed) instead of O(connection lifetime)."""

    # a consumed prefix below this is not worth a compaction copy; above
    # it, compact once consumed >= remaining (each copy moves fewer bytes
    # than were consumed since the last one — amortized O(1)/byte)
    _COMPACT_MIN = 4096

    def __init__(self):
        self._segs: deque = deque()       # unconsumed buffers (memoryview)
        self._off = 0                     # consumed prefix of _segs[0]
        self._size = 0                    # unconsumed bytes across _segs

    def feed(self, data) -> None:
        if not len(data):
            return
        if isinstance(data, (bytearray, memoryview)):
            data = bytes(data)
        self._segs.append(memoryview(data))
        self._size += len(data)

    @property
    def pending_bytes(self) -> int:
        return self._size

    @property
    def retained_bytes(self) -> int:
        """Bytes of *underlying* buffers the decoder keeps alive — the
        connection's true memory footprint, consumed prefixes included
        (a memoryview pins its whole backing buffer)."""
        total = 0
        for seg in self._segs:
            obj = seg.obj
            total += len(obj) if obj is not None else len(seg)
        return total

    def _maybe_compact(self) -> None:
        """Re-home the head segment's unconsumed tail when its consumed
        prefix dominates, releasing the original backing buffer."""
        if self._off < self._COMPACT_MIN or not self._segs:
            return
        head = self._segs[0]
        if self._off * 2 >= len(head):
            self._segs[0] = memoryview(bytes(head[self._off:]))
            self._off = 0

    def frames(self) -> Iterator[Frame]:
        while True:
            f = self._next()
            if f is None:
                return
            yield f

    # -- segment-queue primitives ---------------------------------------
    def _peek(self, n: int) -> bytes:
        """First ``n`` unconsumed bytes without consuming (n is tiny —
        header-sized — so the copy is a few bytes)."""
        head = self._segs[0]
        if len(head) - self._off >= n:
            return bytes(head[self._off:self._off + n])
        out = bytearray()
        off = self._off
        for seg in self._segs:
            out += seg[off:off + (n - len(out))]
            off = 0
            if len(out) >= n:
                break
        return bytes(out)

    def _take(self, n: int) -> memoryview:
        """Consume ``n`` bytes.  Returns a zero-copy view when they lie in
        one segment; joins into a fresh buffer only across a boundary."""
        self._size -= n
        head = self._segs[0]
        if len(head) - self._off >= n:
            out = head[self._off:self._off + n]
            self._off += n
            if self._off == len(head):
                self._segs.popleft()
                self._off = 0
            return out
        parts = bytearray()
        while n:
            head = self._segs[0]
            take = min(len(head) - self._off, n)
            parts += head[self._off:self._off + take]
            self._off += take
            n -= take
            if self._off == len(head):
                self._segs.popleft()
                self._off = 0
        return memoryview(bytes(parts))

    def _next(self) -> Frame | None:
        if self._size < _HEADER.size:
            return None
        plen, ftype = _HEADER.unpack(self._peek(_HEADER.size))
        if plen > MAX_PAYLOAD:
            raise WireError(f"frame length {plen} exceeds MAX_PAYLOAD "
                            f"({MAX_PAYLOAD}) — corrupted length prefix?")
        if ftype not in FRAME_TYPES:
            raise WireError(f"unknown frame type {ftype}")
        if self._size < _HEADER.size + plen + _CRC.size:
            return None
        self._take(_HEADER.size)
        payload = self._take(plen)
        (crc,) = _CRC.unpack(self._take(_CRC.size))
        want = zlib.crc32(payload, zlib.crc32(bytes((ftype,))))
        if crc != want:
            raise WireError(
                f"CRC mismatch on {TYPE_NAMES[ftype]} frame "
                f"(got {crc:#010x}, want {want:#010x})")
        self._maybe_compact()
        return Frame(ftype, payload)


def decode_frames(data: bytes) -> list[Frame]:
    """Decode a complete frame stream; trailing partial bytes are a
    WireError (a *stream* must end on a frame boundary)."""
    dec = FrameDecoder()
    dec.feed(data)
    out = list(dec.frames())
    if dec.pending_bytes:
        raise WireError(f"{dec.pending_bytes} trailing bytes after the last "
                        f"complete frame (truncated stream?)")
    return out


# ----------------------------------------------------------------------
# HELLO
# ----------------------------------------------------------------------

_HELLO = struct.Struct("<4sHBB")     # magic, version, codec_id, flags


def hello_frame(codec: str = "zlib", flags: int = 0) -> Frame:
    from repro_torch.core.chunkstore import _CODEC_IDS
    cid = _CODEC_IDS.get(codec if codec in _CODEC_IDS else "zlib", 1)
    return Frame(HELLO, _HELLO.pack(MAGIC, VERSION, cid, flags))


def parse_hello(frame: Frame) -> dict:
    from repro_torch.core.chunkstore import _CODEC_NAMES
    if frame.ftype != HELLO:
        raise WireError(f"expected HELLO, got {TYPE_NAMES.get(frame.ftype)}")
    try:
        magic, version, cid, flags = _HELLO.unpack(frame.payload)
    except struct.error as e:
        raise WireError(f"malformed HELLO payload: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version} "
                        f"(this side speaks {VERSION})")
    return {"version": version, "codec": _CODEC_NAMES.get(cid, "zlib"),
            "flags": flags}


# ----------------------------------------------------------------------
# JSON control payloads (canonical: sorted keys, compact separators)
# ----------------------------------------------------------------------

def json_frame(ftype: int, obj) -> Frame:
    return Frame(ftype, json.dumps(
        obj, sort_keys=True, separators=(",", ":")).encode())


def parse_json(frame: Frame):
    try:
        return json.loads(str(frame.payload, "utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(
            f"undecodable {TYPE_NAMES.get(frame.ftype, frame.ftype)} "
            f"payload: {e}") from None


# ----------------------------------------------------------------------
# MANIFEST <-> SerializedState
# ----------------------------------------------------------------------

def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def _unb64(s: str) -> bytes:
    try:
        return base64.b64decode(s.encode("ascii"), validate=True)
    except Exception as e:  # noqa: BLE001 — any b64 failure is wire corruption
        raise WireError(f"bad base64 in manifest: {e}") from None


def manifest_frame(ser, *, deleted: Iterable[str] = (),
                   modules: Iterable[str] = (),
                   speculative: bool = False,
                   trickle: bool = False) -> Frame:
    """SerializedState (sans chunk payloads) -> canonical-JSON MANIFEST.
    Chunk *digests* travel here; chunk *bytes* follow in CHUNK frames.
    The ``trickle`` key is emitted only when set so default streams stay
    byte-identical to the golden vector."""
    blobs = {}
    for name, blob in ser.blobs.items():
        arrays = []
        for a in blob.arrays:
            meta = {"shape": list(a["shape"]), "dtype": a["dtype"],
                    "quant": bool(a["quant"]), "chunks": list(a["chunks"]),
                    "clens": list(a["clens"])}
            if a["quant"]:
                meta["block"] = int(a["block"])
                meta["scales"] = _b64(a["scales"])
            arrays.append(meta)
        blobs[name] = {"pickle": _b64(blob.pickle_bytes), "arrays": arrays}
    doc = {
        "codec": ser.codec, "blobs": blobs, "digests": dict(ser.digests),
        "deleted": sorted(deleted), "modules": sorted(modules),
        "skipped": sorted(ser.skipped), "speculative": bool(speculative)}
    if trickle:
        doc["trickle"] = True
    return json_frame(MANIFEST, doc)


def parse_manifest(frame: Frame):
    """MANIFEST frame -> (SerializedState without chunk payloads, deleted
    names, module names, speculative flag, trickle flag).  Chunks arrive
    separately and are attached by the receiver."""
    from repro_torch.core.reducer import SerializedName, SerializedState
    if frame.ftype != MANIFEST:
        raise WireError(
            f"expected MANIFEST, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        blobs = {}
        for name, b in doc["blobs"].items():
            arrays = []
            for a in b["arrays"]:
                meta = {"shape": tuple(a["shape"]), "dtype": a["dtype"],
                        "quant": bool(a["quant"]),
                        "chunks": [int(d) for d in a["chunks"]],
                        "clens": [int(c) for c in a["clens"]]}
                if meta["quant"]:
                    meta["block"] = int(a["block"])
                    meta["scales"] = _unb64(a["scales"])
                arrays.append(meta)
            blobs[name] = SerializedName(pickle_bytes=_unb64(b["pickle"]),
                                         arrays=arrays)
        ser = SerializedState(codec=doc["codec"], blobs=blobs)
        ser.digests = {n: int(d) for n, d in doc["digests"].items()}
        ser.skipped = tuple(doc.get("skipped", ()))
        deleted = tuple(doc.get("deleted", ()))
        modules = tuple(doc.get("modules", ()))
        return (ser, deleted, modules, bool(doc.get("speculative", False)),
                bool(doc.get("trickle", False)))
    except WireError:
        raise
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise WireError(f"malformed manifest: {e!r}") from None


# ----------------------------------------------------------------------
# CHUNK
# ----------------------------------------------------------------------

_DIGEST = struct.Struct("<Q")


def chunk_frame(digest: int, encoded) -> Frame:
    """``encoded`` is the store encoding (1-byte codec tag + body).  The
    chunk bytes become a payload *part*, never copied behind a digest
    prefix — the transport sends them scatter-gather."""
    return Frame(CHUNK, (_DIGEST.pack(digest & (2**64 - 1)), encoded))


def parse_chunk(frame: Frame) -> tuple[int, "bytes | memoryview"]:
    """CHUNK frame -> (digest, store-encoded chunk).  The chunk may be a
    ``memoryview`` into the frame's buffer — zero-copy; callers that need
    owned bytes (a store) materialize it themselves."""
    if frame.ftype != CHUNK:
        raise WireError(f"expected CHUNK, got {TYPE_NAMES.get(frame.ftype)}")
    parts = frame.payload_parts
    if len(parts) == 2 and len(parts[0]) == _DIGEST.size and len(parts[1]):
        # sender-built frame: digest prefix + chunk ride as separate parts
        (digest,) = _DIGEST.unpack(parts[0])
        return digest, parts[1]
    payload = frame.payload
    if len(payload) < _DIGEST.size + 1:
        raise WireError("CHUNK payload too short for digest + codec tag")
    (digest,) = _DIGEST.unpack_from(payload)
    return digest, payload[_DIGEST.size:]


def state_stream_frames(ser, need: Iterable[int], *,
                        deleted: Iterable[str] = ()) -> Iterator[Frame]:
    """The sender's half of a state stream *after* the need-ack: CHUNK
    frames for the requested digests, TOMBSTONE, END.  (The MANIFEST went
    out first to elicit the ack.)"""
    for d in need:
        if d in ser.chunks:
            yield chunk_frame(d, ser.chunks[d])
    deleted = sorted(deleted)
    if deleted:
        yield json_frame(TOMBSTONE, deleted)
    yield Frame(END)


# ----------------------------------------------------------------------
# gateway control plane: ATTACH / DETACH
# ----------------------------------------------------------------------

def attach_frame(tenant: str, notebook: str, cells, *,
                 think: Iterable[float] = (),
                 session: str | None = None) -> Frame:
    """Gateway session attach request.  ``cells`` is a list of
    ``{"source": str, "cost": float|None}`` dicts (the client ships its
    notebook inline; the gateway builds the session's Notebook from it).
    Canonical JSON, so a golden vector pins the format."""
    doc = {"tenant": str(tenant), "notebook": str(notebook),
           "cells": [{"source": str(c["source"]),
                      "cost": None if c.get("cost") is None
                      else float(c["cost"])} for c in cells],
           "think": [float(t) for t in think]}
    if session is not None:
        doc["session"] = str(session)
    return json_frame(ATTACH, doc)


def parse_attach(frame: Frame) -> dict:
    if frame.ftype != ATTACH:
        raise WireError(f"expected ATTACH, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        cells = [{"source": str(c["source"]),
                  "cost": None if c.get("cost") is None else float(c["cost"])}
                 for c in doc["cells"]]
        return {"tenant": str(doc["tenant"]),
                "notebook": str(doc["notebook"]), "cells": cells,
                "think": [float(t) for t in doc.get("think", ())],
                "session": doc.get("session")}
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed ATTACH: {e!r}") from None


def detach_frame(session: str, reason: str = "client") -> Frame:
    """Client-initiated session teardown (or the gateway's completion
    notice when it detaches a drained session)."""
    return json_frame(DETACH, {"session": str(session),
                               "reason": str(reason)})


def parse_detach(frame: Frame) -> tuple[str, str]:
    if frame.ftype != DETACH:
        raise WireError(f"expected DETACH, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        return str(doc["session"]), str(doc.get("reason", "client"))
    except (KeyError, TypeError) as e:
        raise WireError(f"malformed DETACH: {e!r}") from None


# ----------------------------------------------------------------------
# STREAM: the mux envelope (N sessions on one socket)
# ----------------------------------------------------------------------

_STREAM_ID = struct.Struct("<I")


def stream_frame(stream_id: int, inner: Frame) -> Frame:
    """Wrap ``inner`` for one multiplexed stream.  The envelope payload is
    the 4-byte stream id followed by the inner frame's *complete* wire
    encoding (its own header + CRC), carried scatter-gather — the inner
    payload bytes are never copied into the envelope."""
    if not 0 <= stream_id < 2**32:
        raise WireError(f"stream id {stream_id} out of u32 range")
    return Frame(STREAM, (_STREAM_ID.pack(stream_id), *inner.segments()))


def parse_stream(frame: Frame) -> tuple[int, Frame]:
    """STREAM envelope -> (stream_id, inner frame).  The inner frame's
    header, type and CRC are validated exactly as on a bare connection;
    its payload stays a zero-copy view into the envelope's buffer."""
    if frame.ftype != STREAM:
        raise WireError(f"expected STREAM, got {TYPE_NAMES.get(frame.ftype)}")
    buf = frame.payload
    if len(buf) < _STREAM_ID.size + FRAME_OVERHEAD:
        raise WireError("STREAM envelope too short for id + inner frame")
    (sid,) = _STREAM_ID.unpack_from(buf)
    plen, ftype = _HEADER.unpack_from(buf, _STREAM_ID.size)
    if plen > MAX_PAYLOAD:
        raise WireError(f"inner frame length {plen} exceeds MAX_PAYLOAD "
                        f"({MAX_PAYLOAD}) — corrupted envelope?")
    if ftype not in FRAME_TYPES:
        raise WireError(f"unknown inner frame type {ftype}")
    start = _STREAM_ID.size + _HEADER.size
    if len(buf) != start + plen + _CRC.size:
        raise WireError(
            f"STREAM envelope must hold exactly one inner frame "
            f"({len(buf)} bytes, want {start + plen + _CRC.size})")
    payload = buf[start:start + plen]
    (crc,) = _CRC.unpack_from(buf, start + plen)
    want = zlib.crc32(payload, zlib.crc32(bytes((ftype,))))
    if crc != want:
        raise WireError(
            f"CRC mismatch on mux'd {TYPE_NAMES[ftype]} frame "
            f"(got {crc:#010x}, want {want:#010x})")
    return sid, Frame(ftype, payload)


# ----------------------------------------------------------------------
# replica plane: REPLICA / PROMOTE / RACE (additive — v1 byte-stable)
# ----------------------------------------------------------------------

def replica_frame(session: str, epoch: int, *,
                  deleted: Iterable[str] = ()) -> Frame:
    """Replica-plane delta header: announces that the state stream which
    follows is a *convergence* delta for ``session`` up to cell ``epoch``
    (commit sequence number).  ``deleted`` carries names tombstoned since
    the follower's last watermark, so mid-stream deletions converge too."""
    return json_frame(REPLICA, {"session": str(session), "epoch": int(epoch),
                                "deleted": sorted(deleted)})


def parse_replica(frame: Frame) -> dict:
    if frame.ftype != REPLICA:
        raise WireError(f"expected REPLICA, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        return {"session": str(doc["session"]), "epoch": int(doc["epoch"]),
                "deleted": tuple(str(n) for n in doc.get("deleted", ()))}
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed REPLICA: {e!r}") from None


def promote_frame(session: str, epoch: int) -> Frame:
    """Failover handshake: the scheduler promotes this follower to primary
    for ``session``.  ``epoch`` is the commit sequence the promoter believes
    the follower has converged to; the follower replies RESULT with its own
    watermark so a stale promoter learns the real residual."""
    return json_frame(PROMOTE, {"session": str(session), "epoch": int(epoch)})


def parse_promote(frame: Frame) -> tuple[str, int]:
    if frame.ftype != PROMOTE:
        raise WireError(f"expected PROMOTE, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        return str(doc["session"]), int(doc["epoch"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed PROMOTE: {e!r}") from None


def race_frame(race_id: str, action: str, source: str = "") -> Frame:
    """First-result-wins cell race.  ``action`` is ``"run"`` (execute
    ``source``, reply RESULT tagged with the race id) or ``"cancel"``
    (the other leg won; drop the race — a late ``run`` for a cancelled id
    must NOT execute, which is the wire-level clobber protection)."""
    if action not in ("run", "cancel"):
        raise WireError(f"bad RACE action {action!r} (want run|cancel)")
    return json_frame(RACE, {"id": str(race_id), "action": action,
                             "source": str(source)})


def parse_race(frame: Frame) -> dict:
    if frame.ftype != RACE:
        raise WireError(f"expected RACE, got {TYPE_NAMES.get(frame.ftype)}")
    doc = parse_json(frame)
    try:
        action = str(doc["action"])
        if action not in ("run", "cancel"):
            raise ValueError(f"bad action {action!r}")
        return {"id": str(doc["id"]), "action": action,
                "source": str(doc.get("source", ""))}
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed RACE: {e!r}") from None
