"""Resident server mode: keep one warm process, run many jobs.

A cold `python -m fastp_tpu_torch` run pays, before its first batch, for
things that do not depend on the job: the import of torch, the CUDA
context, the loads of the kernels' libraries and of the native host
library (and their builds on a fresh tree), the caching allocator's first
blocks on the card and, with --dedup, the page commit of the Bloom buffers.
A resident server pays them once: `python -m fastp_tpu_torch serve --socket
/path.sock` stays up, and `FASTP_TPU_SERVER=/path.sock python -m
fastp_tpu_torch ...` sends each job to it through the thin client
(client.py imports neither torch nor numpy).  PERF.md has both times as
measured on the card.

What `--warm` and `--warm-run` leave warm: `--warm` resolves the device
(failing at once without a card unless the CPU was asked for), creates the
CUDA context, builds or loads the kernels' three libraries and launches
each kernel once (overlap_sweep, its gapped variant overlap_gap_sweep,
stat_batch, trim_by_sequence);
`--warm-run` also runs one representative job with its output discarded,
which loads the host library, fills the allocator's pool at the job's
batch shape and commits the pooled Bloom buffers
(FASTP_TPU_POOL_PREFAULT, set below, read by duplicate.py).  The step of
a configuration is kept between jobs (pipeline/device.py:memo_step, up to
16 configurations): its stream, pinned buffers, uploaded adapters and, on
a card, its CUDA graph, so after `--warm-run` a job with the same flags
(and the same FASTP_TPU_* variables that a step reads) captures nothing
and replays the warm run's graph.  What belongs to a run -- the
accumulator, the learned quality dictionaries -- starts from zero in every
job.

The device of a job is resolved per job, after the client's FASTP_TPU_*
variables were laid over the server's, so a client's FASTP_TPU_TORCH_DEVICE
travels with its job; without a card and without a request for the CPU the
job fails with a non-zero code on its R frame.

Protocol (unix stream socket, one job per connection):
  request:  one JSON line {"argv": [...], "cwd": "...", "op": "run"}
            (op may also be "ping" or "shutdown")
  response: frames of [tag:1 byte][len:u32 LE][payload]
            tag 'O' = stdout bytes, 'E' = stderr bytes,
            tag 'R' = final JSON {"rc": int} and end-of-job; the reply to
            "ping" also carries the server's "version", "pid" and the count
            of "jobs" it has run
"""
from __future__ import annotations

import json
import os
import socket
import struct
import sys
import traceback

from .config import FASTP_TPU_VER


def send_frame(conn: socket.socket, tag: bytes, payload: bytes):
    conn.sendall(tag + struct.pack("<I", len(payload)) + payload)


def recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = conn.recv(n)
        if not b:
            raise ConnectionError("peer closed")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


class _SockStream:
    """File-like that forwards writes to the client as framed chunks.
    Stands in for sys.stdout / sys.stderr during a job; exposes itself as
    .buffer so `sys.stdout.buffer.write(bytes)` works too."""

    def __init__(self, conn: socket.socket, tag: bytes):
        self._conn = conn
        self._tag = tag
        self.buffer = self
        self.encoding = "utf-8"

    def write(self, data):
        if isinstance(data, str):
            data = data.encode("utf-8", "replace")
        if data:
            send_frame(self._conn, self._tag, data)
        return len(data)

    def flush(self):
        pass

    def isatty(self):
        return False


class _NullStream:
    """Swallow job output during a pre-READY warm run."""

    def __init__(self):
        self.buffer = self
        self.encoding = "utf-8"

    def write(self, data):
        return len(data)

    def flush(self):
        pass

    def isatty(self):
        return False


def _run_job(argv, cwd, conn, jobenv=None) -> int:
    from .cli import main as cli_main
    old_out, old_err, old_cwd = sys.stdout, sys.stderr, os.getcwd()
    # overlay the client's job-level FASTP_TPU_* knobs for this job only
    saved_env = {}
    for k, v in (jobenv or {}).items():
        if not k.startswith("FASTP_TPU_"):
            continue
        saved_env[k] = os.environ.get(k)
        os.environ[k] = str(v)
    if conn is None:
        sys.stdout = _NullStream()
        sys.stderr = _NullStream()
    else:
        sys.stdout = _SockStream(conn, b"O")
        sys.stderr = _SockStream(conn, b"E")
    try:
        os.chdir(cwd)
        # no device argument: the job's device comes from the environment
        # as it stands after the overlay
        rc = cli_main(argv)
        return int(rc) if rc else 0
    except SystemExit as e:
        code = e.code
        if code is None:
            return 0
        return code if isinstance(code, int) else 1
    except BrokenPipeError:
        return 1
    except BaseException:
        try:
            tb = traceback.format_exc()
            sys.stderr.write(tb)
            if conn is None:  # pre-READY warm run: don't lose the evidence
                old_err.write(tb)
                old_err.flush()
        except Exception:
            pass
        return 1
    finally:
        sys.stdout, sys.stderr = old_out, old_err
        os.chdir(old_cwd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def claim_socket(sock_path: str) -> socket.socket:
    """Bind and listen on `sock_path`.  A path that a live server answers on
    is left alone (SystemExit with a message); a socket that refuses the
    connection is a dead server's and is replaced."""
    if os.path.exists(sock_path):
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.connect(sock_path)
        except OSError:
            try:
                os.unlink(sock_path)
            except OSError:
                pass
        else:
            raise SystemExit("fastp_tpu_torch serve: a server already "
                             "answers on %s" % sock_path)
        finally:
            probe.close()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    return srv


def warm_device():
    """Resolve the server's device and, on a card, create the CUDA context,
    build or load the kernels' three libraries (at once) and launch each
    kernel once, so that no job pays for them after READY.  Raises where a
    job would: no card and no request for the CPU."""
    import torch
    from .cli import resolve_device
    from .ops.adapter import trim_by_sequence
    from .ops.overlap_cuda import gap_sweep_select, sweep_select
    from .ops.stats import stat_batch
    device = resolve_device()
    if device.type == "cuda":
        torch.cuda.init()
        from .cuda_build import build_all
        build_all()
    rows = torch.zeros((1, 32), dtype=torch.uint8, device=device)
    lens = torch.zeros(1, dtype=torch.int32, device=device)
    sweep_select(rows, rows.clone(), lens, lens.clone(), 5, 30, 0.2)
    gap_sweep_select(rows, rows.clone(), lens, lens.clone(), 5, 30, 0.2)
    stat_batch(rows, rows.clone(), lens, torch.ones(1, dtype=torch.bool,
                                                    device=device))
    trim_by_sequence(rows, lens, torch.zeros(8, dtype=torch.uint8,
                                             device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return device


def serve(sock_path: str, warm: bool = False, warm_run=None) -> int:
    # resident process: the Bloom buffers are pooled across jobs, so commit
    # their pages once (ideally before READY, in the warm run) instead of
    # by lazy write faults inside every job's batches
    os.environ.setdefault("FASTP_TPU_POOL_PREFAULT", "1")
    srv = claim_socket(sock_path)
    try:
        if warm or warm_run:
            warm_device()
        if warm_run:
            # one representative job before READY: batches pad to
            # --batch_size, so a small input with production flags leaves
            # the allocator's blocks and the host library as the jobs that
            # follow will use them
            rc = _run_job(warm_run, ".", None)
            sys.stdout.write("WARMED rc=%d\n" % rc)
            sys.stdout.flush()
    except BaseException:
        srv.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        raise
    sys.stdout.write("READY %d\n" % os.getpid())
    sys.stdout.flush()
    jobs = 0
    while True:
        conn, _ = srv.accept()
        try:
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(65536)
                if not chunk:
                    buf = b""
                    break
                buf += chunk
            if not buf:
                continue  # a probe: connected and closed without a request
            req = json.loads(buf)
            op = req.get("op", "run")
            if op == "ping":
                send_frame(conn, b"R", json.dumps({
                    "rc": 0, "version": FASTP_TPU_VER, "pid": os.getpid(),
                    "jobs": jobs}).encode())
                continue
            if op == "shutdown":
                send_frame(conn, b"R", json.dumps({"rc": 0}).encode())
                conn.close()
                break
            jobs += 1
            rc = _run_job(req["argv"], req.get("cwd", "."), conn,
                          req.get("env"))
            send_frame(conn, b"R", json.dumps({"rc": rc}).encode())
        except (ConnectionError, BrokenPipeError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
    srv.close()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    return 0


def serve_main(args) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="fastp_tpu_torch serve")
    p.add_argument("--socket", required=True, help="unix socket path")
    p.add_argument("--warm", action="store_true",
                   help="create the CUDA context and load and launch the "
                        "four kernels before READY")
    p.add_argument("--warm-run", default=None, metavar="JSON_ARGV",
                   help="JSON list of the argv (program name first) of a "
                        "representative job to run before READY, after the "
                        "steps of --warm; its stdout and stderr are dropped")
    ns = p.parse_args(args)
    warm_run = json.loads(ns.warm_run) if ns.warm_run else None
    try:
        return serve(ns.socket, warm=ns.warm, warm_run=warm_run)
    except SystemExit:
        raise
    except BaseException:
        # a failure during warm-up otherwise kills the daemon with a
        # traceback nobody captured
        sys.stderr.write("fastp_tpu_torch serve: FATAL\n"
                         + traceback.format_exc())
        sys.stderr.flush()
        raise
