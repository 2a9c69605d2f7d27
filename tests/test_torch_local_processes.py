"""`python -m fastp_tpu_torch --local_processes N` on the CPU: one launcher,
N record-range-sharded processes of the port, one merged report
(fastp_tpu_torch/cli.py:_spawn_local_shards, parallel/multihost.py).

The three cases of tests/test_local_processes.py through the port (the
paired golden at N=2, exact --dedup across three processes, --split
refused), then single-end input, gzip input (record ranges, not byte
ranges), --interleaved_in, --merge --dedup, FASTP_TPU_LOCAL_PROCESSES, a
child that fails (the launcher exits non-zero at once and shows its log),
and a differential against `python -m fastp_tpu --local_processes 2` on a
3,000-pair tools/make_synth.py corpus, shard file by shard file, and on a
40,000-pair corpus that fills the maps of trimmed adapters.  Exact
throughout: the shards' FASTQ files laid end to end equal the single
process's bytes, and the merged fastp.json equals its JSON after the
command-line normalisation.  Every process is asked for the CPU
(FASTP_TPU_TORCH_DEVICE=cpu) and runs torch with one thread.
"""
import gzip
import json
import os
import subprocess
import sys
import time

import pytest

from test_torch_cli import (BENCH, GOLDENS, R1, R2, ROOT, make_corpus,
                            normalize_json, run_module)

PE_OUT = ["-o", "out1.fq", "-O", "out2.fq"]


def _launch(cwd, args, **env_extra):
    """The launcher, whatever its exit code."""
    env = dict(os.environ)
    env["FASTP_TPU_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "fastp_tpu_torch"] + args,
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=900)


def _joined(d, name, n):
    """Shard files 0001.name .. 000n.name of directory d, end to end."""
    out = b""
    for k in range(1, n + 1):
        shard = os.path.join(str(d), "%04d.%s" % (k, name))
        assert os.path.exists(shard), "missing shard %s" % shard
        with open(shard, "rb") as fh:
            out += fh.read()
    return out


def assert_shards_equal_single(shard_dir, n, single_dir, names):
    for name in names:
        with open(os.path.join(str(single_dir), name), "rb") as fh:
            want = fh.read()
        assert want, name
        assert _joined(shard_dir, name, n) == want, name
    with open(os.path.join(str(shard_dir), "fastp.json")) as fa, \
            open(os.path.join(str(single_dir), "fastp.json")) as fb:
        assert normalize_json(fa.read()) == normalize_json(fb.read())
    # the shards' logs and the files of their exchange are gone
    assert [f for f in os.listdir(str(shard_dir)) if f.startswith(".")] == []


def test_local_processes_pe_golden(tmp_path):
    """ONE command with --local_processes 2: concatenated shard outputs and
    the merged JSON must equal the single-process golden."""
    res = _launch(tmp_path, ["-i", R1, "-I", R2] + PE_OUT
                  + ["--local_processes", "2"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert "running on cpu" in res.stderr
    assert_shards_equal_single(tmp_path, 2, os.path.join(
        GOLDENS, "cfg2_pe_default"), ("out1.fq", "out2.fq"))
    assert not os.path.exists(tmp_path / "out1.fq")


@pytest.fixture(scope="module")
def dup_corpus(tmp_path_factory):
    """3,000 pairs with a fifth of them duplicates."""
    d = tmp_path_factory.mktemp("dup")
    r1, r2 = str(d / "R1.fq"), str(d / "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "3000", "--dup-rate", "0.2", "--seed", "11",
                    "--out1", r1, "--out2", r2], check=True, capture_output=True)
    return r1, r2


def test_local_processes_dedup_exact(dup_corpus, tmp_path):
    """--dedup across 3 local processes (two rounds of the file exchange: the
    dedup pre-pass and the final stats merge) must byte-match the
    single-process run."""
    r1, r2 = dup_corpus
    args = ["-i", r1, "-I", r2] + PE_OUT + ["--dedup"]
    single, multi = tmp_path / "single", tmp_path / "multi"
    single.mkdir()
    multi.mkdir()
    run_module("fastp_tpu_torch", single, args)
    res = _launch(multi, args + ["--local_processes", "3"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert_shards_equal_single(multi, 3, single, ("out1.fq", "out2.fq"))
    with open(single / "out1.fq", "rb") as fh:   # the run did drop duplicates
        assert fh.read().count(b"\n") < 4 * 3000


@pytest.mark.parametrize("args,message", [
    (["-i", R1, "-o", "out1.fq", "--split", "3", "--local_processes", "2"],
     "--split cannot be combined with --local_processes"),
    (["--stdin", "-o", "out1.fq", "--local_processes", "2"],
     "--local_processes does not support STDIN"),
])
def test_local_processes_split_conflict(tmp_path, args, message):
    """--split (outputs are already sharded per process) and STDIN input are
    refused up front, before any child starts."""
    res = _launch(tmp_path, args)
    assert res.returncode != 0
    assert message in res.stderr
    assert "running on" not in res.stderr
    assert os.listdir(tmp_path) == []


def test_local_processes_se_golden(tmp_path):
    res = _launch(tmp_path, ["-i", R1, "-o", "out.fq", "--local_processes", "3"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert_shards_equal_single(tmp_path, 3, os.path.join(
        GOLDENS, "cfg1_se_default"), ("out.fq",))


def test_local_processes_variable(tmp_path):
    """FASTP_TPU_LOCAL_PROCESSES=N is --local_processes N; the children do
    not inherit it (they would start children of their own)."""
    res = _launch(tmp_path, ["-i", R1, "-I", R2] + PE_OUT + ["--correction",
                                                             "--cut_right"],
                  FASTP_TPU_LOCAL_PROCESSES="2")
    assert res.returncode == 0, res.stderr[-4000:]
    assert_shards_equal_single(tmp_path, 2, os.path.join(
        GOLDENS, "cfg3_pe_correction"), ("out1.fq", "out2.fq"))


def test_local_processes_gz_input(tmp_path):
    """Gzip input cannot be cut at byte offsets: the shards take record
    ranges of the inflated stream."""
    for src, name in ((R1, "R1.fq.gz"), (R2, "R2.fq.gz")):
        with open(src, "rb") as fin, gzip.open(tmp_path / name, "wb") as out:
            out.write(fin.read())
    run = tmp_path / "run"
    run.mkdir()
    res = _launch(run, ["-i", str(tmp_path / "R1.fq.gz"), "-I",
                        str(tmp_path / "R2.fq.gz")] + PE_OUT
                  + ["--local_processes", "2"])
    assert res.returncode == 0, res.stderr[-4000:]
    single = tmp_path / "single"
    single.mkdir()
    run_module("fastp_tpu_torch", single,
               ["-i", str(tmp_path / "R1.fq.gz"), "-I",
                str(tmp_path / "R2.fq.gz")] + PE_OUT)
    assert_shards_equal_single(run, 2, single, ("out1.fq", "out2.fq"))
    # and the FASTQ bytes are the plain input's
    for name in ("out1.fq", "out2.fq"):
        with open(os.path.join(GOLDENS, "cfg2_pe_default", name), "rb") as fh:
            assert _joined(run, name, 2) == fh.read()


def test_local_processes_interleaved(tmp_path):
    inter = tmp_path / "inter.fq"
    with open(R1, "rb") as f1, open(R2, "rb") as f2, open(inter, "wb") as out:
        while True:
            rec1 = [f1.readline() for _ in range(4)]
            rec2 = [f2.readline() for _ in range(4)]
            if not rec1[0]:
                break
            out.writelines(rec1 + rec2)
    args = ["-i", str(inter), "--interleaved_in"] + PE_OUT
    single, multi = tmp_path / "single", tmp_path / "multi"
    single.mkdir()
    multi.mkdir()
    run_module("fastp_tpu_torch", single, args)
    res = _launch(multi, args + ["--local_processes", "3"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert_shards_equal_single(multi, 3, single, ("out1.fq", "out2.fq"))
    # a shard never splits a pair: both mates' files hold the same reads
    for k in (1, 2, 3):
        with open(multi / ("%04d.out1.fq" % k), "rb") as f1, \
                open(multi / ("%04d.out2.fq" % k), "rb") as f2:
            names1 = [ln.split()[0] for ln in f1.read().split(b"\n")[0::4] if ln]
            names2 = [ln.split()[0] for ln in f2.read().split(b"\n")[0::4] if ln]
        assert names1 == names2 and names1


def test_local_processes_merge_dedup(dup_corpus, tmp_path):
    """cfg5's flags less --overrepresentation_analysis (that analysis samples
    reads by their index within a process, in fastp_tpu too, so its counts
    are a process's own): merged reads, unmerged mates and the report are
    exact across shards."""
    r1, r2 = dup_corpus
    args = ["-i", r1, "-I", r2, "--merge", "--merged_out", "merged.fq",
            "--out1", "out1.fq", "--out2", "out2.fq", "--dedup",
            "--dup_calc_accuracy", "1"]
    single, multi = tmp_path / "single", tmp_path / "multi"
    single.mkdir()
    multi.mkdir()
    run_module("fastp_tpu_torch", single, args)
    res = _launch(multi, args + ["--local_processes=2"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert_shards_equal_single(multi, 2, single,
                               ("merged.fq", "out1.fq", "out2.fq"))


def test_a_failing_child_ends_the_job(tmp_path):
    """Shard 1 cannot open its output (a directory has its name): the
    launcher exits non-zero without waiting for the exchange to time out,
    shows that shard's log and keeps it."""
    (tmp_path / "0002.out1.fq").mkdir()
    t0 = time.time()
    res = _launch(tmp_path, ["-i", R1, "-I", R2] + PE_OUT
                  + ["--local_processes", "2"])
    assert res.returncode != 0
    assert time.time() - t0 < 300
    assert "shard 1/2 exited with" in res.stderr
    assert "0002.out1.fq" in res.stderr and "Error" in res.stderr
    assert os.path.exists(tmp_path / ".fastp_shard_log.1")
    assert not os.path.exists(tmp_path / "fastp.json")
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".fastp_shard.")]


def test_launcher_without_a_card_fails_once(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ)
    env.pop("FASTP_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu_torch", "-i", R1,
                          "-o", "out.fq", "--local_processes", "2"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stderr.count("FASTP_TPU_TORCH_DEVICE") >= 1
    assert "shard" not in res.stderr       # no child was started
    assert os.listdir(tmp_path) == []


def test_matches_fastp_tpu_shard_by_shard(tmp_path):
    """The same corpus and flags through `python -m fastp_tpu
    --local_processes 2` and the port's: every shard file and the merged
    report are equal, so both cut the input at the same records."""
    r1, r2 = make_corpus(tmp_path, pairs=3000, seed=5)
    args = ["-i", r1, "-I", r2] + PE_OUT + BENCH + ["--local_processes", "2"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    jax = subprocess.Popen(
        [sys.executable, "-m", "fastp_tpu"] + args, cwd=str(theirs),
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                 PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    res = _launch(ours, args)
    _, jax_err = jax.communicate(timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    assert jax.returncode == 0, jax_err[-4000:]
    names = sorted(f for f in os.listdir(theirs) if f.endswith(".fq"))
    assert names == ["0001.out1.fq", "0001.out2.fq", "0002.out1.fq",
                     "0002.out2.fq"]
    for name in names:
        with open(ours / name, "rb") as fa, open(theirs / name, "rb") as fb:
            a, b = fa.read(), fb.read()
        assert a == b and a, name
    with open(ours / "fastp.json") as fa, open(theirs / "fastp.json") as fb:
        assert normalize_json(fa.read()) == normalize_json(fb.read())


def test_capped_adapter_maps_across_shards_match_fastp_tpu(tmp_path):
    """40,000 pairs that all read through their adapter give more than the
    20,000 distinct trimmed sequences a map of adapters takes.  Then
    read1/read2_adapter_counts depend on how the input was cut, in numbers
    and in which sequences reach the one percent that gets them named: one
    process and two shards differ there and nowhere else, and the port's
    report equals `python -m fastp_tpu`'s in both."""
    r1, r2 = str(tmp_path / "R1.fq"), str(tmp_path / "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "40000", "--short-insert-rate", "1.0",
                    "--seed", "7", "--out1", r1, "--out2", r2],
                   check=True, capture_output=True)
    args = ["-i", r1, "-I", r2] + PE_OUT + [
        "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", "--adapter_sequence_r2",
        "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT", "--batch_size", "4096"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", FASTP_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {}
    for module in ("fastp_tpu_torch", "fastp_tpu"):
        for n in (1, 2):
            d = tmp_path / ("%s_%d" % (module, n))
            d.mkdir()
            extra = ["--local_processes", "2"] if n == 2 else []
            runs[module, n] = d, subprocess.Popen(
                [sys.executable, "-m", module] + args + extra, cwd=str(d),
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)
    reports = {}
    for key, (d, proc) in runs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, (key, err[-4000:])
        with open(d / "fastp.json") as fh:
            reports[key] = normalize_json(fh.read()).split("\n")
    for n in (1, 2):
        assert reports["fastp_tpu_torch", n] == reports["fastp_tpu", n], n

    def counts(report):
        found = [json.loads("{" + ln.strip().rstrip(",") + "}")
                 for ln in report if "_adapter_counts" in ln]
        assert len(found) == 2
        return [next(iter(f.values())) for f in found]

    whole, sharded = reports["fastp_tpu_torch", 1], reports["fastp_tpu_torch", 2]
    assert ([ln for ln in whole if "_adapter_counts" not in ln]
            == [ln for ln in sharded if "_adapter_counts" not in ln])
    for one, two in zip(counts(whole), counts(sharded)):
        assert sum(one.values()) < sum(two.values())     # the one map capped
        assert set(two) < set(one)       # and so names more sequences


# the launcher in a child interpreter that refuses torch to itself only: the
# children it starts are interpreters of their own, which import torch
_NO_TORCH_LAUNCHER = """
import runpy
import sys


class NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError("the launcher imported " + name)


sys.meta_path.insert(0, NoTorch())
sys.argv[0] = "fastp_tpu_torch"
runpy.run_module("fastp_tpu_torch", run_name="__main__")
"""


def test_the_launcher_imports_no_torch(tmp_path):
    """As fastp_tpu's launcher reaches its shards without importing JAX,
    the port's reaches them without torch: the children pay its import,
    the launcher does not pay it before them."""
    env = dict(os.environ)
    env["FASTP_TPU_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    res = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_LAUNCHER, "-i", R1, "-I", R2]
        + PE_OUT + ["--local_processes", "2"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "the launcher imported" not in res.stderr
    assert "running on cpu" in res.stderr
    assert_shards_equal_single(tmp_path, 2, os.path.join(
        GOLDENS, "cfg2_pe_default"), ("out1.fq", "out2.fq"))


@pytest.mark.parametrize("request_,error", [
    ("meta", "cpu, cuda or cuda:N"), ("cpu,cuda:0", "all cpu or all cuda"),
    ("cuda", "FASTP_TPU_TORCH_DEVICE"), ("cuda:0,cuda:0", "FASTP_TPU_TORCH_DEVICE")])
def test_the_launcher_checks_the_request_without_torch(request_, error,
                                                      monkeypatch):
    """What resolve_devices refuses, launcher_devices refuses too (no card
    here)."""
    from fastp_tpu_torch import cli
    if cli.cuda_card_count() and "FASTP" in error:
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", request_)
    with pytest.raises((ValueError, RuntimeError), match=error):
        cli.launcher_devices()
    assert cli.launcher_devices("cpu") == (["cpu"], 0)
    assert cli.launcher_devices(["cpu", "cpu"]) == (["cpu", "cpu"], 0)
