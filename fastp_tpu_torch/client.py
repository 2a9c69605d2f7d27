"""Thin client for the resident server (see server.py).

Imports neither torch nor numpy, so a client starts in the time the
interpreter takes and a short job pays none of the accelerator's one-time
costs.  Used automatically by `python -m fastp_tpu_torch ...` when
FASTP_TPU_SERVER names a live socket.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import sys


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = conn.recv(n)
        if not b:
            raise ConnectionError("server closed")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def _request(sock_path: str, req: dict, out=None, err=None):
    """Send one request line and read frames up to the R frame; O and E
    payloads go to `out` and `err`.  Returns the R frame's JSON, or None
    if the server is unreachable or closes early."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        conn.connect(sock_path)
        conn.sendall((json.dumps(req) + "\n").encode())
        while True:
            tag = _recv_exact(conn, 1)
            (n,) = struct.unpack("<I", _recv_exact(conn, 4))
            payload = _recv_exact(conn, n) if n else b""
            if tag == b"R":
                return json.loads(payload)
            sink = out if tag == b"O" else err if tag == b"E" else None
            if sink is not None:
                sink.write(payload)
                sink.flush()
    except (OSError, ConnectionError):
        return None
    finally:
        conn.close()


def run_via_server(sock_path: str, argv):
    """Run `argv` on the resident server. Returns the job's exit code, or
    None if the server is unreachable (caller should fall back to local)."""
    # job-level knobs (the device, shard index/count from the
    # --local_processes launcher, debug toggles) ride the request so the
    # resident server applies them for this job only
    jobenv = {k: v for k, v in os.environ.items()
              if k.startswith("FASTP_TPU_") and k != "FASTP_TPU_SERVER"}
    reply = _request(sock_path, {"op": "run", "argv": list(argv),
                                 "cwd": os.getcwd(), "env": jobenv},
                     getattr(sys.stdout, "buffer", sys.stdout),
                     getattr(sys.stderr, "buffer", sys.stderr))
    return None if reply is None else reply["rc"]


def ping(sock_path: str):
    """The server's {"rc", "version", "pid", "jobs"}, or None if nothing
    answers on the socket."""
    return _request(sock_path, {"op": "ping"})


def shutdown_server(sock_path: str) -> bool:
    return _request(sock_path, {"op": "shutdown"}) is not None
