"""End-to-end runs of the non-lean PE path of `python -m fastp_tpu_torch`
on the CPU: --failed_out, unpaired outputs, --overlapped_out and split
output.

* the cfg6, cfg7 and cfg8 goldens: every FASTQ file each golden holds
  byte for byte, fastp.json after the command-line normalisation; cfg6
  and cfg8 also with FASTP_TPU_NO_NATIVE=1, where the per-row routing
  loop replaces the native route_pe;
* differential runs against `python -m fastp_tpu` on the 2,000-pair
  tools/make_synth.py corpus: cfg8's flags (with and without the native
  library in the port's environment) and split output over two workers;
* the correction-slot overflow path of a non-lean step, which re-derives
  corrections from the shipped per-read overlap fields.
"""
import os

import pytest

from fastp_tpu_torch import cli
from fastp_tpu_torch.ops import correct as t_correct
from test_torch_cli import (GOLDENS, R1, R2, assert_same_outputs, make_corpus,
                            one_torch_thread, run_module)  # noqa: F401

PE = ["-i", R1, "-I", R2]
CFG6 = ["-o", "out1.fq", "-O", "out2.fq", "--failed_out", "failed.fq",
        "--unpaired1", "up1.fq", "--unpaired2", "up2.fq", "-l", "100"]
CFG7 = ["-o", "out1.fq", "-O", "out2.fq", "-s", "3", "-w", "1"]
CFG8 = ["-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
        "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
        "--overlapped_out", "ov.fq", "-l", "100"]
GOLDEN_FLAGS = {"cfg6_failed": CFG6, "cfg7_split": CFG7,
                "cfg8_failed_cut": CFG8}
CASES = {
    "cfg8": CFG8,
    "split": ["-o", "out1.fq", "-O", "out2.fq", "-s", "3", "-w", "2",
              "--batch_size", "256", "--correction"],
}


@pytest.mark.parametrize("golden,no_native", [
    ("cfg6_failed", False), ("cfg7_split", False), ("cfg8_failed_cut", False),
    ("cfg6_failed", True), ("cfg8_failed_cut", True)])
def test_golden(golden, no_native, tmp_path):
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    run_module("fastp_tpu_torch", tmp_path, PE + GOLDEN_FLAGS[golden], **env)
    files = assert_same_outputs(tmp_path, os.path.join(GOLDENS, golden))
    assert len(files) == {"cfg6_failed": 6, "cfg7_split": 7,
                          "cfg8_failed_cut": 6}[golden]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The 2,000-pair corpus, and fastp_tpu's run of each case."""
    d = tmp_path_factory.mktemp("failed")
    r1, r2 = make_corpus(d)
    runs = {}
    for name, flags in CASES.items():
        runs[name] = d / ("jax_" + name)
        runs[name].mkdir()
        run_module("fastp_tpu", runs[name], ["-i", r1, "-I", r2] + flags)
    return ["-i", r1, "-I", r2], runs


@pytest.mark.parametrize("name,no_native", [
    ("cfg8", False), ("cfg8", True), ("split", False)])
def test_matches_fastp_tpu(corpus, name, no_native, tmp_path):
    inputs, runs = corpus
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    run_module("fastp_tpu_torch", tmp_path, inputs + CASES[name], **env)
    files = assert_same_outputs(tmp_path, runs[name])
    for f in files:  # every stream of the case carries reads
        assert os.path.getsize(tmp_path / f) > 0, f


def test_correction_overflow_non_lean(corpus, tmp_path, monkeypatch):
    """cfg8's flags with 4 correction slots: every batch overflows, so the
    host recomputes each correctable pair from the step's ov_* fields."""
    inputs, runs = corpus
    sparse = t_correct.extract_deltas_sparse
    counts = []

    def four_slots(mask, seq, qual, C):
        out = sparse(mask, seq, qual, 4)
        counts.append(int(out[4]))
        return out

    monkeypatch.setattr(t_correct, "extract_deltas_sparse", four_slots)
    monkeypatch.chdir(tmp_path)
    cli.run(["fastp_tpu_torch"] + inputs + CFG8, device="cpu")
    assert max(counts) > 4
    assert_same_outputs(tmp_path, runs["cfg8"])
