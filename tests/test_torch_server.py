"""The port's resident server and thin client on the CPU
(fastp_tpu_torch/server.py, client.py, __main__.py).

One `python -m fastp_tpu_torch serve` is started for the module (asked for
the CPU with FASTP_TPU_TORCH_DEVICE=cpu, one OpenMP thread) and takes the
jobs of tests/test_server.py and more through `python -m fastp_tpu_torch`
with FASTP_TPU_SERVER set: cfg1 twice and cfg3 once against tests/golden,
`--stdout` through O frames, a job that ends in error_exit, the `ping`
fields.  Further servers show that a live socket is refused and a stale
one replaced; a dead socket makes the client fall back to a local run; the
client path runs with torch and numpy blocked against a stub server; and
a client's FASTP_TPU_* variables hold for their job only.  Every comparison
is exact: FASTQ bytes, and fastp.json after the command-line normalisation.
"""
import json
import os
import socket
import struct
import subprocess
import sys
import threading

import pytest

from fastp_tpu_torch import client, server
from fastp_tpu_torch.config import FASTP_TPU_VER
from fastp_tpu_torch.io import native as t_native
from test_torch_cli import (GOLDENS, R1, R2, ROOT, assert_same_outputs,
                            one_torch_thread)  # noqa: F401

CFG1 = ["-i", R1, "-o", "out.fq"]
CFG3 = ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq", "--correction",
        "--cut_right"]


def _env(**extra):
    env = dict(os.environ)
    env["FASTP_TPU_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.pop("FASTP_TPU_SERVER", None)
    env.update(extra)
    return env


def _start_server(cwd, sock, *flags, **env):
    """A server process and its first line of standard output."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastp_tpu_torch", "serve", "--socket", sock,
         *flags], cwd=str(cwd), env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, proc.stdout.readline()


def _stop(proc, sock):
    if proc.poll() is None:
        client.shutdown_server(sock)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()
    proc.stderr.close()


def _job(cwd, args, sock, **env):
    """`python -m fastp_tpu_torch args` with FASTP_TPU_SERVER=sock."""
    cwd.mkdir(exist_ok=True)
    return subprocess.run([sys.executable, "-m", "fastp_tpu_torch"] + args,
                          cwd=str(cwd), env=_env(FASTP_TPU_SERVER=sock, **env),
                          capture_output=True, timeout=600)


class Served:
    """The module's server: its socket, its pid, and the jobs sent so far."""

    def __init__(self, proc, sock, pid):
        self.proc, self.sock, self.pid, self.jobs = proc, sock, pid, 0

    def run(self, cwd, args, **env):
        self.jobs += 1
        return _job(cwd, args, self.sock, **env)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv")
    sock = str(d / "s.sock")
    proc, line = _start_server(d, sock, "--warm")
    try:
        assert line.startswith("READY"), line + proc.stderr.read()[-3000:]
        assert int(line.split()[1]) == proc.pid
        yield Served(proc, sock, proc.pid)
        rc_alive = proc.poll()
        assert client.shutdown_server(sock)
        assert proc.wait(timeout=30) == 0 and rc_alive is None
        assert not os.path.exists(sock)
    finally:
        _stop(proc, sock)


@pytest.mark.parametrize("name,golden,args", [
    ("cfg1_first", "cfg1_se_default", CFG1),
    ("cfg1_again", "cfg1_se_default", CFG1),
    ("cfg3", "cfg3_pe_correction", CFG3)])
def test_served_job_matches_golden(served, tmp_path, name, golden, args):
    res = served.run(tmp_path, args)
    assert res.returncode == 0, res.stderr[-3000:]
    # the job's log came back through E frames, and the job ran in the server
    assert b"running on cpu" in res.stderr
    assert b"JSON report" in res.stderr
    assert_same_outputs(tmp_path, os.path.join(GOLDENS, golden))


def test_stdout_travels_in_o_frames(served, tmp_path):
    res = served.run(tmp_path, ["-i", R1, "--stdout"])
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(GOLDENS, "cfg1_se_default", "out.fq"), "rb") as fh:
        assert res.stdout == fh.read()
    assert b"running on cpu" in res.stderr
    assert not os.path.exists(tmp_path / "out.fq")


def test_error_exit_leaves_the_server_alive(served, tmp_path):
    res = served.run(tmp_path, ["-i", str(tmp_path / "no_such.fq"), "-o",
                                "out.fq"])
    assert res.returncode != 0
    assert b"ERROR" in res.stderr and b"no_such.fq" in res.stderr
    assert b"running locally" not in res.stderr
    assert served.proc.poll() is None
    again = served.run(tmp_path / "after", CFG1)
    assert again.returncode == 0, again.stderr[-3000:]
    assert_same_outputs(tmp_path / "after",
                        os.path.join(GOLDENS, "cfg1_se_default"))


def test_a_jobs_device_request_travels_with_it(served, tmp_path):
    """The device is resolved per job, after the client's variables were
    laid over the server's: a job that asks for a card this host lacks
    fails on its R frame and writes nothing; the server and the next job,
    which asks for the CPU again, are not touched."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the job would run on it")
    res = served.run(tmp_path / "cuda", CFG1, FASTP_TPU_TORCH_DEVICE="cuda")
    assert res.returncode != 0
    assert b"FASTP_TPU_TORCH_DEVICE" in res.stderr
    assert b"running on" not in res.stderr
    assert os.listdir(tmp_path / "cuda") == []
    res = served.run(tmp_path / "cpu", CFG1)
    assert res.returncode == 0 and b"running on cpu" in res.stderr


def test_ping_reports_version_pid_and_jobs(served, tmp_path):
    before = client.ping(served.sock)
    assert before == {"rc": 0, "version": FASTP_TPU_VER, "pid": served.pid,
                      "jobs": served.jobs}
    served.run(tmp_path, CFG1)
    assert client.ping(served.sock)["jobs"] == before["jobs"] + 1


def test_live_socket_is_refused(served, tmp_path):
    second = subprocess.run(
        [sys.executable, "-m", "fastp_tpu_torch", "serve", "--socket",
         served.sock], cwd=str(tmp_path), env=_env(), capture_output=True,
        text=True, timeout=120)
    assert second.returncode != 0
    assert "already answers" in second.stderr
    assert "READY" not in second.stdout
    assert os.path.exists(served.sock)
    pong = client.ping(served.sock)
    assert pong is not None and pong["pid"] == served.pid


def _dead_socket(path):
    """A socket file nobody listens on, as a killed server leaves it."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.close()
    assert os.path.exists(path)


def test_stale_socket_is_replaced(tmp_path):
    sock = str(tmp_path / "stale.sock")
    _dead_socket(sock)
    assert client.ping(sock) is None
    proc, line = _start_server(tmp_path, sock)
    try:
        assert line.startswith("READY"), line + proc.stderr.read()[-3000:]
        pong = client.ping(sock)
        assert pong["pid"] == proc.pid and pong["jobs"] == 0
        assert client.shutdown_server(sock)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(sock)
    finally:
        _stop(proc, sock)


def test_dead_socket_falls_back_to_a_local_run(tmp_path):
    sock = str(tmp_path / "dead.sock")
    _dead_socket(sock)
    run = tmp_path / "run"
    res = _job(run, CFG1, sock)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stderr.count(b"running locally") == 1
    assert b"running on cpu" in res.stderr
    assert_same_outputs(run, os.path.join(GOLDENS, "cfg1_se_default"))


def test_server_without_a_card_fails_at_warm(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    sock = str(tmp_path / "s.sock")
    env = _env()
    env.pop("FASTP_TPU_TORCH_DEVICE")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu_torch", "serve",
                          "--socket", sock, "--warm"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "READY" not in res.stdout
    assert "FASTP_TPU_TORCH_DEVICE" in res.stderr
    assert not os.path.exists(sock)


def test_warm_run_happens_before_ready(tmp_path):
    sock = str(tmp_path / "s.sock")
    warm = ["fastp_tpu_torch", "-i", R1, "-o", "warm.fq", "-j", "warm.json",
            "-h", "warm.html"]
    proc, line = _start_server(tmp_path, sock, "--warm-run", json.dumps(warm))
    try:
        assert line == "WARMED rc=0\n", line + proc.stderr.read()[-3000:]
        assert proc.stdout.readline().startswith("READY")
        with open(tmp_path / "warm.fq", "rb") as fa, open(os.path.join(
                GOLDENS, "cfg1_se_default", "out.fq"), "rb") as fb:
            assert fa.read() == fb.read()
        assert client.ping(sock)["jobs"] == 0   # the warm run is no job
    finally:
        _stop(proc, sock)


# -- the client alone, against a stub server ---------------------------------

class StubServer(threading.Thread):
    """Answers one request on a unix socket with fixed frames and keeps the
    request; speaks the protocol with its own code, not server.py's."""

    def __init__(self, path, frames):
        super().__init__(daemon=True)
        self.frames, self.request = frames, None
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(1)

    def run(self):
        conn, _ = self.sock.accept()
        buf = b""
        while not buf.endswith(b"\n"):
            buf += conn.recv(65536)
        self.request = json.loads(buf)
        for tag, payload in self.frames:
            conn.sendall(tag + struct.pack("<I", len(payload)) + payload)
        conn.close()
        self.sock.close()


BLOCKED_CLIENT = r"""
import runpy, sys
sys.modules["torch"] = None
sys.modules["numpy"] = None
sys.argv = ["fastp_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("fastp_tpu_torch", run_name="__main__")
finally:
    loaded = [m for m in ("torch", "numpy", "fastp_tpu_torch.cli")
              if sys.modules.get(m) is not None]
    assert not loaded, loaded
"""


def test_client_path_imports_neither_torch_nor_numpy(tmp_path):
    sock = str(tmp_path / "stub.sock")
    stub = StubServer(sock, [(b"E", b"log line\n"), (b"O", b"@r\nACGT\n"),
                             (b"O", b""), (b"O", b"+\nFFFF\n"),
                             (b"R", json.dumps({"rc": 7}).encode())])
    stub.start()
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLIENT, "-i", "in.fq", "--stdout"],
        cwd=str(tmp_path), capture_output=True, timeout=60,
        env=_env(FASTP_TPU_SERVER=sock, FASTP_TPU_NO_NATIVE="1", OTHER="x"))
    stub.join(timeout=30)
    assert res.returncode == 7, res.stderr[-3000:]
    assert res.stdout == b"@r\nACGT\n+\nFFFF\n"
    assert res.stderr == b"log line\n"
    req = stub.request
    assert req["op"] == "run" and req["cwd"] == str(tmp_path)
    assert req["argv"][1:] == ["-i", "in.fq", "--stdout"]
    # the job-level variables and nothing else of the environment
    assert req["env"]["FASTP_TPU_TORCH_DEVICE"] == "cpu"
    assert req["env"]["FASTP_TPU_NO_NATIVE"] == "1"
    assert all(k.startswith("FASTP_TPU_") for k in req["env"])
    assert "FASTP_TPU_SERVER" not in req["env"]


@pytest.mark.parametrize("argv", [["--stdin", "-o", "o.fq"],
                                  ["-i", "/dev/stdin"],
                                  ["-i", "a.fq", "--local_processes", "2"],
                                  ["-i", "a.fq", "--local_processes=2"]])
def test_jobs_that_stay_local(tmp_path, argv):
    """STDIN jobs and the --local_processes launcher never go to the server:
    with torch blocked they fail on the import of the local path, and the
    stub sees no request."""
    sock = str(tmp_path / "stub.sock")
    stub = StubServer(sock, [(b"R", json.dumps({"rc": 0}).encode())])
    stub.start()
    res = subprocess.run([sys.executable, "-c", BLOCKED_CLIENT] + argv,
                         cwd=str(tmp_path), capture_output=True, timeout=60,
                         env=_env(FASTP_TPU_SERVER=sock), stdin=subprocess.DEVNULL)
    assert res.returncode != 0
    assert b"torch" in res.stderr
    assert stub.request is None
    assert client.ping(sock) == {"rc": 0}   # lets the stub's thread end
    stub.join(timeout=30)


def test_client_functions_on_no_server(tmp_path):
    sock = str(tmp_path / "none.sock")
    assert client.ping(sock) is None
    assert client.run_via_server(sock, ["prog", "-i", "x"]) is None
    assert client.shutdown_server(sock) is False


# -- server.py in this process -----------------------------------------------

def test_frames_round_trip():
    a, b = socket.socketpair()
    try:
        payload = bytes(range(256)) * 300
        server.send_frame(a, b"O", payload)
        server.send_frame(a, b"R", b"")
        head = server.recv_exact(b, 5)
        assert head[:1] == b"O" and struct.unpack("<I", head[1:])[0] == len(payload)
        assert server.recv_exact(b, len(payload)) == payload
        assert server.recv_exact(b, 5) == b"R" + struct.pack("<I", 0)
        a.close()
        with pytest.raises(ConnectionError):
            server.recv_exact(b, 1)
    finally:
        a.close()
        b.close()


def test_sock_stream_frames_text_and_bytes():
    a, b = socket.socketpair()
    try:
        out = server._SockStream(a, b"E")
        assert out.buffer is out and not out.isatty()
        assert out.write("hé") == len("hé".encode()) and out.write(b"") == 0
        out.buffer.write(b"\x00\xff")
        out.flush()
        a.close()
        got = b""
        while True:
            chunk = b.recv(100)
            if not chunk:
                break
            got += chunk
        text = "hé".encode()
        assert got == (b"E" + struct.pack("<I", len(text)) + text
                       + b"E" + struct.pack("<I", 2) + b"\x00\xff")
    finally:
        b.close()


def _run_job_here(tmp_path, monkeypatch, args, jobenv):
    """server._run_job in this process, with no client (output dropped);
    returns (rc, what get_lib gave and what the environment held while the
    processor ran)."""
    from fastp_tpu_torch.pipeline import runner
    seen = {}
    real = runner.SingleEndProcessor.process

    def spy(self):
        seen["lib"] = t_native.get_lib()
        seen["env"] = {k: v for k, v in os.environ.items()
                       if k in ("FASTP_TPU_NO_NATIVE", "OTHER_VARIABLE")}
        seen["stdout"] = sys.stdout
        return real(self)

    monkeypatch.setattr(runner.SingleEndProcessor, "process", spy)
    rc = server._run_job(["fastp_tpu_torch"] + args, str(tmp_path), None,
                         jobenv)
    return rc, seen


def test_client_variable_applies_to_its_job_only(tmp_path, monkeypatch):
    """FASTP_TPU_NO_NATIVE=1 from a client turns the native library off for
    that job (the Python paths give the same bytes) and is gone after it;
    variables outside FASTP_TPU_* are not taken over."""
    monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FASTP_TPU_NO_NATIVE", raising=False)
    before = (sys.stdout, sys.stderr, os.getcwd(), dict(os.environ))
    rc, seen = _run_job_here(tmp_path, monkeypatch, CFG1,
                             {"FASTP_TPU_NO_NATIVE": "1",
                              "OTHER_VARIABLE": "x"})
    assert rc == 0
    assert seen["lib"] is None
    assert seen["env"] == {"FASTP_TPU_NO_NATIVE": "1"}
    assert isinstance(seen["stdout"], server._NullStream)
    assert (sys.stdout, sys.stderr, os.getcwd(), dict(os.environ)) == before
    assert_same_outputs(tmp_path, os.path.join(GOLDENS, "cfg1_se_default"))
    rc, seen = _run_job_here(tmp_path, monkeypatch, CFG1, {})
    assert rc == 0 and seen["env"] == {}
    if t_native._lib is not None:   # this host built the library
        assert seen["lib"] is t_native._lib


def test_a_job_that_dies_leaves_nothing_behind(tmp_path, monkeypatch):
    """A job that raises between batches: rc 1, the streams, the directory
    and the environment are the server's again, the writer threads have
    ended and the pooled Bloom buffers are back in the pool."""
    from fastp_tpu_torch import duplicate
    from fastp_tpu_torch.pipeline import runner

    def boom(self, *a, **k):
        raise RuntimeError("batch failed")

    released = []
    real_release = duplicate.Duplicate.release
    monkeypatch.setattr(duplicate.Duplicate, "release",
                        lambda self: (released.append(1), real_release(self))[1])
    monkeypatch.setattr(runner.SingleEndProcessor, "_process_batch", boom)
    monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", "cpu")
    before = (sys.stdout, sys.stderr, os.getcwd())
    threads = set(threading.enumerate())
    rc = server._run_job(["fastp_tpu_torch"] + CFG1 + ["--dedup"],
                         str(tmp_path), None, {"FASTP_TPU_X": "1"})
    assert rc == 1
    assert (sys.stdout, sys.stderr, os.getcwd()) == before
    assert "FASTP_TPU_X" not in os.environ
    assert released
    new = set(threading.enumerate()) - threads
    for t in new:   # release() zeroes the buffers in a thread that then ends
        t.join(timeout=30)
    assert not [t for t in new if t.is_alive()], new
