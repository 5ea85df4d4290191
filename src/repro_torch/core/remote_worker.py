"""The receiver half of a :class:`~repro_torch.core.transport.SubprocessEnv`.

    python -m repro_torch.core.remote_worker --connect HOST:PORT [--codec zlib] \
        [--device cuda|cpu]

Connects back to the parent, then serves the wire protocol until BYE: state
streams land in a real :class:`MemoryChunkStore` and materialize into this
process's namespace, EXEC runs cells against that namespace, FETCH streams
requested state back (the round trip home).  This is the smallest honest
"remote kernel": everything the parent knows about it, it learned through
frames.  Digests, chunk keys and quantization run on ``--device``
(default ``cuda``: the hand-written kernels; ``cpu``: their plain PyTorch
versions), as in every entry point of the port.
"""
from __future__ import annotations

import argparse
import socket
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--codec", default="zlib")
    ap.add_argument("--chunk-bytes", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    # imports deferred past argparse so --help stays instant
    from repro_torch.core.chunkstore import CHUNK_BYTES, MemoryChunkStore
    from repro_torch.core.reducer import StateReducer
    from repro_torch.core.transport import (
        SocketTransport, WireReceiver, serve_receiver,
    )

    host, _, port = args.connect.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=30.0)
    sock.settimeout(None)
    transport = SocketTransport(sock)
    reducer = StateReducer(
        codec=args.codec,
        chunk_bytes=args.chunk_bytes if args.chunk_bytes else CHUNK_BYTES,
        device=args.device)
    receiver = WireReceiver(MemoryChunkStore(), reducer,
                            ns={"__builtins__": __builtins__})
    try:
        err = serve_receiver(receiver, transport, timeout=None)
    finally:
        transport.close()
    if err is not None:
        print(f"remote_worker: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
