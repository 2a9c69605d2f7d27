"""End-to-end runs of `python -m fastp_tpu_torch` on the CPU.

* the cfg3 golden (tests/golden/cfg3_pe_correction), and the PE default
  and NovaSeq goldens the same code covers: FASTQ byte for byte, JSON
  after the tests/test_parity.py normalisation;
* a differential run against `python -m fastp_tpu` on a 2,000-pair
  tools/make_synth.py corpus with the bench flags;
* the correction-slot overflow path (exact host recomputation) against the
  normal sparse path on the same corpus;
* the options outside the ported slice fail with their ROADMAP item.
"""
import os
import re
import subprocess
import sys

import pytest

from fastp_tpu_torch import cli
from fastp_tpu_torch.ops import correct as t_correct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "golden")
R1 = os.path.join(ROOT, "tests", "testdata", "R1.fq")
R2 = os.path.join(ROOT, "tests", "testdata", "R2.fq")
BENCH = ["--correction", "--cut_right",
         "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
         "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
OUTPUTS = ("out1.fq", "out2.fq", "fastp.json")


def normalize_json(text):
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def assert_same_outputs(dir_a, dir_b):
    for f in OUTPUTS:
        with open(os.path.join(dir_a, f), "rb") as fa, \
                open(os.path.join(dir_b, f), "rb") as fb:
            a, b = fa.read(), fb.read()
        if f.endswith(".json"):
            assert normalize_json(a.decode()) == normalize_json(b.decode()), f
        else:
            assert a == b, f


def run_module(module, cwd, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", module] + args, cwd=str(cwd),
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 2,000-pair corpus and the port's run of it with the bench flags."""
    d = tmp_path_factory.mktemp("synth")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "2000", "--seed", "7",
                    "--out1", str(d / "R1.fq"), "--out2", str(d / "R2.fq")],
                   check=True, capture_output=True)
    port = d / "port"
    port.mkdir()
    args = ["-i", str(d / "R1.fq"), "-I", str(d / "R2.fq"),
            "-o", "out1.fq", "-O", "out2.fq"] + BENCH
    res = run_module("fastp_tpu_torch", port, args)
    assert "running on cpu" in res.stderr
    return d, args


@pytest.mark.parametrize("golden,flags", [
    ("cfg3_pe_correction", ["--correction", "--cut_right"]),
    ("cfg2_pe_default", []),
    ("cfg4_novaseq", ["--trim_poly_g", "--trim_poly_x", "--umi", "--umi_loc",
                      "read1", "--umi_len", "4", "--low_complexity_filter"]),
])
def test_golden(golden, flags, tmp_path):
    run_module("fastp_tpu_torch", tmp_path,
               ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"] + flags)
    assert_same_outputs(tmp_path, os.path.join(GOLDENS, golden))


def test_matches_fastp_tpu_on_synthetic_corpus(synth, tmp_path):
    d, args = synth
    run_module("fastp_tpu", tmp_path, args)
    assert_same_outputs(d / "port", tmp_path)


def test_correction_overflow_path_is_exact(synth, tmp_path, monkeypatch):
    """With 4 correction slots every batch overflows, so the host
    recomputes each correctable pair; the outputs must not change."""
    d, args = synth
    sparse = t_correct.extract_deltas_sparse
    counts = []

    def four_slots(mask, seq, qual, C):
        out = sparse(mask, seq, qual, 4)
        counts.append(int(out[4]))
        return out

    monkeypatch.setattr(t_correct, "extract_deltas_sparse", four_slots)
    monkeypatch.chdir(tmp_path)
    cli.run(["fastp_tpu_torch"] + args)
    assert max(counts) > 4
    assert_same_outputs(d / "port", tmp_path)


@pytest.mark.parametrize("args,item", [
    (["-I", R2, "--local_processes", "2"], "item 13"),
    (["-I", R2, "--devices", "2"], "item 13"),
    (["-I", R2, "--stdout"], "item 11"),
    (["--interleaved_in"], "item 11"),
    (["-I", R2, "-s", "2"], "item 8"),
])
def test_options_outside_the_slice(args, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        cli.run(["fastp_tpu_torch", "-i", R1, "-o", "o1.fq", "-O", "o2.fq"]
                + args)


def test_single_end_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.run(["fastp_tpu_torch", "-i", R1, "-o", "o.fq"])
