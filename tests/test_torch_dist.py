"""Shards of one job on several hosts: the exchange over torch.distributed.

Two processes of the port on 127.0.0.1, a free port, the gloo backend and
FASTP_TPU_TORCH_DEVICE=cpu, each started with the same command line and its
own RANK, as one process per host would be.  Each takes its record-aligned
range of the input and writes its "0001."/"0002."-prefixed outputs; the
dedup verdicts and the final stats are gathered over the process group, and
rank 0 writes the one report.  FASTP_TPU_FS_EXCHANGE is NOT set: an exchange
that fell back to files would end the run with an error.  The three cases of
tests/test_multihost.py (exact equality throughout):

* PE default against the cfg2 golden, the shards' files joined in order;
* gzip input (sharded by record ranges) against the port's single process;
* --dedup with duplicates across the shard boundary against the port's
  single process, and the merged report against that of the file exchange
  (`--local_processes 2`);

then `--local_processes 2` with FASTP_TPU_SERVERS naming two resident
servers (each shard runs inside a server of its own, and the exchange goes
through files) against the plain `--local_processes 2` run; and the rules of
the exchange: no process group without the four
variables, a shard of --local_processes never starts one, and a group that
fails is an error unless FASTP_TPU_FS_EXCHANGE=1 asks for the files.
"""
import gzip
import os
import socket
import subprocess
import sys

import pytest

from fastp_tpu_torch.parallel import mesh as t_mesh
from fastp_tpu_torch.parallel import multihost as t_multihost
from test_torch_cli import (GOLDENS, R1, R2, ROOT, assert_same_outputs,
                            normalize_json, one_torch_thread,
                            run_module)  # noqa: F401
from fastp_tpu_torch import client
from test_torch_mesh import _make_corpus
from test_torch_server import _start_server, _stop

CHILD_TIMEOUT = 240   # seconds for a pair of ranks, well under the suite's


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_env(rank, world, port, **extra):
    env = dict(os.environ)
    env.pop("FASTP_TPU_FS_EXCHANGE", None)
    env.update(FASTP_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK=str(rank), WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo")
    env.update(extra)
    return env


def run_ranks(cwd, args, world=2):
    """`python -m fastp_tpu_torch args` as `world` ranks in cwd; returns
    their stderr texts."""
    os.makedirs(cwd, exist_ok=True)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastp_tpu_torch"] + args, cwd=str(cwd),
        env=dist_env(k, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return errs


def joined(cwd, name, world=2):
    data = b""
    for k in range(1, world + 1):
        with open(os.path.join(cwd, "%04d.%s" % (k, name)), "rb") as f:
            data += f.read()
    return data


def assert_joined_equals(multi, single, names=("out1.fq", "out2.fq")):
    for name in names:
        with open(os.path.join(single, name), "rb") as f:
            assert joined(multi, name) == f.read(), name
    with open(os.path.join(multi, "fastp.json")) as a, \
            open(os.path.join(single, "fastp.json")) as b:
        assert normalize_json(a.read()) == normalize_json(b.read())
    assert not [f for f in os.listdir(multi) if f.startswith(".fastp_shard")]


def test_two_ranks_pe_default_golden(tmp_path):
    errs = run_ranks(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O",
                                "out2.fq"])
    assert_joined_equals(tmp_path, os.path.join(GOLDENS, "cfg2_pe_default"))
    # rank 0 alone prints the merged summary
    assert "Filtering result:" in errs[0]
    assert "Filtering result:" not in errs[1]


def test_two_ranks_gzip_input(tmp_path):
    r1, r2 = _make_corpus(tmp_path, 2500, 13)
    for path in (r1, r2):
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb",
                                              compresslevel=4) as g:
            g.write(f.read())
    args = ["-i", r1 + ".gz", "-I", r2 + ".gz", "-o", "out1.fq", "-O",
            "out2.fq", "--batch_size", "1024"]
    (tmp_path / "single").mkdir()
    run_module("fastp_tpu_torch", tmp_path / "single", args)
    run_ranks(tmp_path / "multi", args)
    assert_joined_equals(tmp_path / "multi", tmp_path / "single")
    assert os.path.getsize(tmp_path / "multi" / "0002.out1.fq") > 0


def test_two_ranks_dedup_across_the_boundary(tmp_path):
    r1, r2 = _make_corpus(tmp_path, 3000, 11, "--dup-rate", "0.2")
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", "--dedup",
            "--batch_size", "1024"]
    for d in ("single", "files"):
        (tmp_path / d).mkdir()
    run_module("fastp_tpu_torch", tmp_path / "single", args)
    run_ranks(tmp_path / "multi", args)
    assert_joined_equals(tmp_path / "multi", tmp_path / "single")
    # the same job over the file exchange: same shards, same report
    run_module("fastp_tpu_torch", tmp_path / "files",
               args + ["--local_processes", "2"])
    files = assert_same_outputs(tmp_path / "multi", tmp_path / "files")
    assert "0002.out2.fq" in files
    # duplicates were dropped, some of them pairs whose first occurrence
    # lies in the other shard: the shards' own verdicts would keep those
    with open(tmp_path / "single" / "out1.fq", "rb") as f:
        kept = f.read().count(b"\n") // 4
    assert kept < 3000


def test_local_processes_through_two_servers(tmp_path):
    r1, r2 = _make_corpus(tmp_path, 1500, 19, "--dup-rate", "0.2")
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", "--dedup",
            "--correction", "--batch_size", "512", "--local_processes", "2"]
    socks = [str(tmp_path / ("s%d.sock" % k)) for k in range(2)]
    servers = [_start_server(tmp_path, sock) for sock in socks]
    try:
        for proc, line in servers:
            assert line.startswith("READY"), line + proc.stderr.read()[-3000:]
        (tmp_path / "served").mkdir()
        res = run_module("fastp_tpu_torch", tmp_path / "served", args,
                         FASTP_TPU_SERVERS=",".join(socks))
        assert "Filtering result:" in res.stderr     # shard 0's console
        assert [client.ping(sock)["jobs"] for sock in socks] == [1, 1]
    finally:
        for (proc, _), sock in zip(servers, socks):
            _stop(proc, sock)
    (tmp_path / "plain").mkdir()
    run_module("fastp_tpu_torch", tmp_path / "plain", args)
    files = assert_same_outputs(tmp_path / "served", tmp_path / "plain")
    assert "0002.out1.fq" in files
    assert sorted(os.listdir(tmp_path / "served")) \
        == sorted(os.listdir(tmp_path / "plain"))


def test_no_group_without_the_variables(monkeypatch):
    for k in t_mesh.DIST_ENV + ("FASTP_TPU_SHARD_COUNT",
                                "FASTP_TPU_SHARD_INDEX"):
        monkeypatch.delenv(k, raising=False)
    assert t_mesh.init_distributed() is False
    assert t_mesh.process_group() is None
    assert not t_multihost.active()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("RANK", "0")
    assert t_mesh.init_distributed() is False     # no WORLD_SIZE
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert t_mesh.init_distributed() is False     # a world of one
    assert "torch.distributed" not in sys.modules or not \
        sys.modules["torch.distributed"].is_initialized()


def test_a_shard_of_local_processes_starts_no_group(monkeypatch):
    """The launcher's children exchange through files: with the shard
    variables set the four torch.distributed variables are left alone (N
    children with one RANK would wait for each other for ever)."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("FASTP_TPU_SHARD_COUNT", "2")
    monkeypatch.setenv("FASTP_TPU_SHARD_INDEX", "1")
    assert t_mesh.init_distributed() is False
    assert (t_multihost.process_index(), t_multihost.process_count()) == (1, 2)


def test_shard_variables_come_before_the_group(monkeypatch):
    monkeypatch.setattr(t_mesh, "process_group", lambda: (3, 4))
    monkeypatch.delenv("FASTP_TPU_SHARD_COUNT", raising=False)
    assert t_multihost.active()
    assert (t_multihost.process_index(), t_multihost.process_count()) == (3, 4)
    monkeypatch.setenv("FASTP_TPU_SHARD_COUNT", "2")
    monkeypatch.setenv("FASTP_TPU_SHARD_INDEX", "1")
    assert (t_multihost.process_index(), t_multihost.process_count()) == (1, 2)
    monkeypatch.delenv("FASTP_TPU_SHARD_COUNT")
    monkeypatch.setattr(t_mesh, "process_group", lambda: (0, 1))
    assert not t_multihost.active()


def test_a_failed_group_is_an_error_unless_files_are_asked_for(
        tmp_path, monkeypatch, capsys):
    """No quiet change of route: when the gather over the group raises, the
    run ends with the reference's words; with FASTP_TPU_FS_EXCHANGE=1 it
    says so and takes the files."""
    def broken(payload):
        raise RuntimeError("connection reset")

    monkeypatch.delenv("FASTP_TPU_SHARD_COUNT", raising=False)
    monkeypatch.delenv("FASTP_TPU_FS_EXCHANGE", raising=False)
    monkeypatch.setattr(t_mesh, "process_group", lambda: (0, 1))
    monkeypatch.setattr(t_multihost, "_allgather_bytes_torch", broken)
    with pytest.raises(SystemExit):
        t_multihost.allgather_state({"a": 1}, str(tmp_path))
    err = capsys.readouterr().err
    assert "cross-process stats collectives are unavailable (RuntimeError)" in err
    assert "FASTP_TPU_FS_EXCHANGE=1" in err
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("FASTP_TPU_FS_EXCHANGE", "1")
    t_multihost._exchange_round[0] = 0
    assert t_multihost.allgather_state({"a": 1}, str(tmp_path)) == [{"a": 1}]
    assert "using shared-filesystem stats exchange" in capsys.readouterr().err


TEARDOWN_CHILD = r"""
import os, sys
import torch.distributed as dist
log, how = sys.argv[1], sys.argv[2]
destroy = dist.destroy_process_group


def recording(*args, **kw):
    with open(log, "a") as fh:
        fh.write("destroyed\n")
    return destroy(*args, **kw)


dist.destroy_process_group = recording
from fastp_tpu_torch import cli
from fastp_tpu_torch.parallel import mesh
if how == "run":
    cli.run(["fastp_tpu_torch"] + sys.argv[3:], device="cpu")
    # torn down before cli.run returned
    assert not dist.is_initialized() and mesh.process_group() is None
    with open(log, "a") as fh:
        fh.write("returned\n")
else:
    # a process that never reaches cli.run's end: the group goes at exit
    assert mesh.init_distributed() and dist.is_initialized()
    with open(log, "a") as fh:
        fh.write("started\n")
"""


@pytest.mark.parametrize("how", ["run", "exit"])
def test_every_rank_destroys_its_group_before_exit(tmp_path, how):
    """Each rank that started a gloo group calls destroy_process_group once:
    at the end of cli.run, or at interpreter exit when the process started
    the group some other way (mesh.init_distributed's atexit hook)."""
    port = free_port()
    args = (["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"]
            if how == "run" else [])
    procs = [subprocess.Popen(
        [sys.executable, "-c", TEARDOWN_CHILD, "log.%d" % k, how] + args,
        cwd=str(tmp_path), env=dist_env(k, 2, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    first = "destroyed" if how == "run" else "started"
    for k in range(2):
        with open(tmp_path / ("log.%d" % k)) as fh:
            lines = fh.read().split()
        assert lines == ([first, "returned"] if how == "run"
                         else [first, "destroyed"]), (k, lines)
    if how == "run":
        assert_joined_equals(tmp_path, os.path.join(GOLDENS, "cfg2_pe_default"))


FAILING_CHILD = r"""
import sys
import torch.distributed as dist
log, how, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
destroy = dist.destroy_process_group


def recording(*args, **kw):
    with open(log, "a") as fh:
        fh.write("destroyed\n")
    return destroy(*args, **kw)


dist.destroy_process_group = recording
from fastp_tpu_torch import cli
from fastp_tpu_torch.parallel import mesh, multihost


def fail_early(*args, **kw):
    raise RuntimeError("rank 1 fails before its first gather")


if how == "run":
    if rank == 1:
        cli._run_processor = fail_early
    cli.run(["fastp_tpu_torch"] + sys.argv[4:], device="cpu")
else:
    assert mesh.init_distributed()
    if rank == 1:
        fail_early()   # uncaught: the atexit hook tears the group down
    multihost._allgather_bytes_torch(b"rank 0's payload")
"""


@pytest.mark.parametrize("how", ["run", "exit"])
def test_a_rank_that_fails_does_not_hold_its_peers(tmp_path, how):
    """A rank that raises after the group started leaves at once (no
    barrier on the way out), and its peer's next gather fails when the
    connection drops: both ranks exit with an error well within the
    group's timeout, and each destroyed its group."""
    import time
    port = free_port()
    args = (["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"]
            if how == "run" else [])
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", FAILING_CHILD, "log.%d" % k, how, str(k)]
        + args, cwd=str(tmp_path), env=dist_env(k, 2, port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    limit = t_mesh.DIST_TIMEOUT_S / 4
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, limit - (time.monotonic() - t0)))
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert time.monotonic() - t0 < limit
    assert "rank 1 fails before its first gather" in errs[1], errs[1][-4000:]
    for k, p in enumerate(procs):
        assert p.returncode != 0, (k, errs[k][-4000:])
        with open(tmp_path / ("log.%d" % k)) as fh:
            assert fh.read().split() == ["destroyed"], (k, errs[k][-4000:])
