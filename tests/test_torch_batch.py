"""`python -m fastp_tpu_torch.batch`: the port's batch runner
(fastp_tpu_torch/batch.py), on the CPU.

A directory of three samples (two paired, one single-end) goes through
the runner in one process and through `--parallel 2` worker processes;
each sample's gzip FASTQ output (inflated) and report must equal a direct
`python -m fastp_tpu_torch` run of the arguments `build_args` gives, and
`overall.html` must name every sample.  The device is resolved once for
the whole batch: with no card and no request for the CPU the runner exits
non-zero before it writes anything.  Exact comparisons throughout.
"""
import gzip
import os
import shutil
import subprocess
import sys

import pytest
import torch

from fastp_tpu_torch import batch
from test_torch_cli import (R1, R2, ROOT, make_corpus, normalize_json,
                            one_torch_thread, run_module)  # noqa: F401

EXTRA = ["--correction", "--cut_right"]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """in/: a_R1/a_R2 (the golden inputs), b_R1/b_R2 (600 synthetic pairs),
    c.fq (single-end), and a file the runner must skip."""
    d = tmp_path_factory.mktemp("batch")
    indir = d / "in"
    indir.mkdir()
    shutil.copy(R1, indir / "a_R1.fq")
    shutil.copy(R2, indir / "a_R2.fq")
    r1, r2 = make_corpus(d, pairs=600, seed=3)
    shutil.move(r1, indir / "b_R1.fq")
    shutil.move(r2, indir / "b_R2.fq")
    shutil.copy(R1, indir / "c.fq")
    shutil.copy(R1, indir / "Undetermined_S0.fq")
    (indir / "notes.txt").write_text("not a FASTQ file\n")
    return d, str(indir)


@pytest.fixture(scope="module")
def direct(samples):
    """Each job run directly with the arguments the runner builds."""
    d, indir = samples
    jobs = batch.scan_dir(indir)
    os.makedirs(d / "direct_rep")
    for job in jobs:
        run_module("fastp_tpu_torch", d, batch.build_args(
            job, str(d / "direct_out"), str(d / "direct_rep"), EXTRA))
    return jobs


def _gunzip(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _assert_equals_direct(d, out, rep):
    names = sorted(os.listdir(d / "direct_out"))
    assert names == ["a_R1.clean.fastq.gz", "a_R2.clean.fastq.gz",
                     "b_R1.clean.fastq.gz", "b_R2.clean.fastq.gz",
                     "c.clean.fastq.gz"]
    assert sorted(os.listdir(d / out)) == names
    for name in names:
        ours = _gunzip(d / out / name)
        assert ours == _gunzip(d / "direct_out" / name) and ours, name
    reports = sorted(f for f in os.listdir(d / "direct_rep"))
    assert sorted(f for f in os.listdir(d / rep) if f != "overall.html") == reports
    for name in (f for f in reports if f.endswith(".json")):
        with open(d / rep / name) as fa, open(d / "direct_rep" / name) as fb:
            assert normalize_json(fa.read()) == normalize_json(fb.read()), name
    with open(d / rep / "overall.html") as fh:
        html = fh.read()
    assert "fastp_tpu_torch" in html
    for sample in ("a_pe.fq", "b_pe.fq", "c.fq"):
        assert sample in html


def test_scan_finds_the_three_samples(samples, direct):
    _, indir = samples
    assert [(os.path.basename(a), b and os.path.basename(b)) for a, b in direct] \
        == [("a_R1.fq", "a_R2.fq"), ("b_R1.fq", "b_R2.fq"), ("c.fq", None)]


def test_batch_in_one_process_equals_direct_runs(samples, direct, capsys):
    d, indir = samples
    rc = batch.main(["-i", indir, "-o", str(d / "out"), "-r", str(d / "rep"),
                     "--args=" + " ".join(EXTRA)], device="cpu")
    assert rc == 0
    said = capsys.readouterr()
    assert said.out.count("Processing: ") == 3 and "Batch done: 3" in said.out
    assert said.err.count("running on cpu") == 3
    _assert_equals_direct(d, "out", "rep")


def test_batch_module_with_worker_processes(samples, direct):
    d, indir = samples
    res = run_module("fastp_tpu_torch.batch", d, [
        "-i", indir, "-o", str(d / "out_p"), "-r", str(d / "rep_p"),
        "--args=" + " ".join(EXTRA), "--parallel", "2"])
    assert res.stdout.count("Running: fastp_tpu_torch ") == 3
    _assert_equals_direct(d, "out_p", "rep_p")


def test_the_device_is_resolved_once_for_the_batch(samples, monkeypatch,
                                                   tmp_path):
    """batch.main hands one torch.device to every job, however many there
    are; the jobs resolve none themselves."""
    from fastp_tpu_torch import cli
    _, indir = samples
    calls, devices = [], []
    real = cli.resolve_device
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device=None: (calls.append(device), real(device))[1])
    monkeypatch.setattr(cli, "main", lambda argv, device=None: devices.append(device) or 0)
    monkeypatch.setattr(batch, "generate_summary_html", lambda report_dir: None)
    assert batch.main(["-i", indir, "-r", str(tmp_path)], device="cpu") == 0
    assert calls == ["cpu"]
    assert devices == [torch.device("cpu")] * 3


def test_an_empty_directory_is_an_error(tmp_path, capsys):
    assert batch.main(["-i", str(tmp_path)], device="cpu") == 1
    assert "No FASTQ file found" in capsys.readouterr().out


def test_no_card_and_no_request_writes_nothing(samples, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the batch would use it")
    _, indir = samples
    env = dict(os.environ)
    env.pop("FASTP_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu_torch.batch", "-i",
                          indir, "-o", str(tmp_path / "out"), "-r",
                          str(tmp_path / "rep")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "FASTP_TPU_TORCH_DEVICE" in res.stderr
    assert os.listdir(tmp_path) == []
