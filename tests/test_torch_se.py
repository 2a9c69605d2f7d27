"""End-to-end single-end runs of `python -m fastp_tpu_torch` on the CPU.

* the cfg1 golden (tests/golden/cfg1_se_default): out.fq byte for byte,
  fastp.json after the command-line normalisation;
* differential runs against `python -m fastp_tpu` on R1 of the 2,000-pair
  tools/make_synth.py corpus: the SE default, --failed_out with cutting
  and an explicit adapter, and split output by lines, every output file
  compared; the --failed_out case also with FASTP_TPU_NO_NATIVE=1 in the
  port's environment (the Python serializer instead of the native one).
"""
import os

import pytest

from test_torch_cli import (GOLDENS, R1, assert_same_outputs, make_corpus,
                            run_module)

ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
CASES = {
    "cfg1": [],
    "failed_cut": ["--failed_out", "failed.fq", "--cut_front", "--cut_tail",
                   "-l", "60", "-a", ADAPTER],
    "split_lines": ["--split_by_lines", "2000", "--batch_size", "256",
                    "--trim_poly_x"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """R1 of the 2,000-pair corpus, and fastp_tpu's run of each case."""
    d = tmp_path_factory.mktemp("se")
    r1, _ = make_corpus(d)
    runs = {}
    for name, flags in CASES.items():
        runs[name] = d / ("jax_" + name)
        runs[name].mkdir()
        run_module("fastp_tpu", runs[name], ["-i", r1, "-o", "out.fq"] + flags)
    return r1, runs


def test_golden_cfg1(tmp_path):
    res = run_module("fastp_tpu_torch", tmp_path, ["-i", R1, "-o", "out.fq"])
    assert "running on cpu" in res.stderr
    files = assert_same_outputs(tmp_path, os.path.join(GOLDENS,
                                                       "cfg1_se_default"))
    assert files == ["fastp.json", "out.fq"]


@pytest.mark.parametrize("name,no_native", [
    ("cfg1", False), ("failed_cut", False), ("split_lines", False),
    ("failed_cut", True)])
def test_matches_fastp_tpu(corpus, name, no_native, tmp_path):
    r1, runs = corpus
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    run_module("fastp_tpu_torch", tmp_path, ["-i", r1, "-o", "out.fq"]
               + CASES[name], **env)
    files = assert_same_outputs(tmp_path, runs[name])
    if name == "failed_cut":
        assert os.path.getsize(tmp_path / "failed.fq") > 0
    if name == "split_lines":  # the output really rotates over files
        assert len([f for f in files if f.endswith(".out.fq")]) > 1
