"""`python -m fastp_tpu_torch test`: the port's built-in self-test
(fastp_tpu_torch/selftest.py), on the CPU.

The checks carry the names and print the lines of `python -m fastp_tpu
test`; here each is held to PASSED by its name, the entry point to its exit
codes (0, and 1 when a check fails), and the device rule to the self-test
too: no card and no request for the CPU is an error before any check runs.
On a card the three overlap checks go through the hand-written kernel at
one pair row (the test of that is marked `cuda` and skips without a card).
"""
import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from fastp_tpu_torch import cli, selftest
from fastp_tpu_torch.ops import common as t_common
from fastp_tpu_torch.ops import overlap_cuda
# every op module is imported before a test puts a wrong function into
# ops/common.py: a module imported later would keep the wrong one
from fastp_tpu_torch.ops import (adapter, correct, merge, overlap,  # noqa: F401
                                 polyx, trim)
from test_torch_cli import ROOT, one_torch_thread  # noqa: F401

CHECKS = ["Sequence::reverseComplement", "Read::lastIndex",
          "FastqReader::read", "Filter::trimAndCut", "PolyX::trimPolyX",
          "AdapterTrimmer::trimBySequence", "OverlapAnalysis::analyze",
          "ReadPair::fastMerge", "BaseCorrector::correctByOverlapAnalysis",
          "NucleotideTree::getDominantPath", "Evaluator::seq2int"]


def _module(args, **env_extra):
    env = dict(os.environ)
    env.pop("FASTP_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "fastp_tpu_torch"] + args,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def module_run():
    return _module(["test"], FASTP_TPU_TORCH_DEVICE="cpu")


def test_entry_point_exits_zero_with_all_passed(module_run):
    assert module_run.returncode == 0, module_run.stderr[-3000:]
    lines = module_run.stdout.splitlines()
    assert lines[-1] == "ALL PASSED" and lines[-2] == "=" * 26
    assert [ln for ln in lines if ln.endswith(": PASSED")] \
        == [name + ": PASSED" for name in CHECKS]
    assert "FAILED" not in module_run.stdout


@pytest.mark.parametrize("name", CHECKS)
def test_check_passes(module_run, name):
    assert (name + ": PASSED") in module_run.stdout.splitlines()


def _run_here(device="cpu"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ok = selftest.run_self_tests(torch.device(device))
    return ok, out.getvalue()


def test_a_failing_check_fails_the_run(monkeypatch):
    """A wrong reverse complement: that check says FAILED, the others
    still run and pass, and the entry point exits 1."""
    real = t_common.rc
    monkeypatch.setattr(t_common, "rc", lambda seq, lens: real(seq, lens) ^ 1)
    ok, text = _run_here()
    assert ok is False
    lines = text.splitlines()
    assert "Sequence::reverseComplement: FAILED" in lines
    assert [ln for ln in lines if ln.endswith(": PASSED")] \
        == [name + ": PASSED" for name in CHECKS[1:]]
    assert lines[-1] == "SOME FAILED"
    assert sum(ln.endswith((": PASSED", ": FAILED")) for ln in lines) == len(CHECKS)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["fastp_tpu_torch", "test"], device="cpu") == 1


def test_main_returns_zero_on_the_cpu():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(["fastp_tpu_torch", "test"], device="cpu") == 0
    assert out.getvalue().endswith("ALL PASSED\n")


def test_no_card_and_no_request_runs_no_check():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the self-test would use it")
    res = _module(["test"])
    assert res.returncode != 0
    assert "FASTP_TPU_TORCH_DEVICE" in res.stderr
    assert "PASSED" not in res.stdout


def test_usage_names_the_other_entry_points():
    res = _module([])
    assert res.returncode == 0
    assert "also: fastp_tpu_torch test" in res.stderr
    assert "fastp_tpu_torch serve --socket PATH" in res.stderr


def test_on_the_cpu_the_kernel_is_not_launched():
    before = overlap_cuda.sweep_select.launches
    ok, _ = _run_here()
    assert ok and overlap_cuda.sweep_select.launches == before


@pytest.mark.cuda
def test_on_the_card_the_overlap_checks_launch_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = overlap_cuda.sweep_select.launches
    ok, text = _run_here("cuda")
    assert ok, text
    assert overlap_cuda.sweep_select.launches - before >= 2
