"""Input and output modes of `python -m fastp_tpu_torch` on the CPU, each
against `python -m fastp_tpu` on the same input (every output file and the
standard output byte for byte, fastp.json after the command-line
normalisation):

* --interleaved_in, which must also equal the port's run of the same
  pairs from two files;
* --stdin --interleaved_in --stdout (pairs in and out through pipes);
* PE --stdout without --merge (interleaved pairs) and with it (the merged
  stream; the side streams keep their files);
* SE --adapter_fasta with a two-adapter FASTA;
* --allow_gap_overlap_trimming with correction;
* a PE251 corpus (tools/make_synth.py --read-len 251) with the bench flags;
* the NovaSeq flags of cfg4 (polyG and polyX trimming, a UMI taken from
  read 1, the low-complexity filter) on the 2,000-pair corpus, PE and SE.

And --stdin --stdout on the cfg1 input gives the cfg1 golden's out.fq.
The fastp_tpu runs start together, four at a time, in a module fixture.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_cli import (BENCH, GOLDENS, R1, ROOT, assert_same_outputs,
                            make_corpus, run_module)
from test_torch_step import FASTA
PAIRS = ["-i", "{r1}", "-I", "{r2}"]
NOVASEQ = ["--trim_poly_g", "--trim_poly_x", "--umi", "--umi_loc", "read1",
           "--umi_len", "4", "--low_complexity_filter"]
# name -> (arguments, file for standard input, file for standard output)
CASES = {
    "interleaved": (["-i", "{il}", "--interleaved_in", "-o", "out1.fq",
                     "-O", "out2.fq"] + BENCH, None, None),
    "stdin_interleaved": (["--stdin", "--interleaved_in", "--stdout",
                           "--correction", "--cut_right"], "{il}", "stdout.fq"),
    "stdout": (PAIRS + ["--stdout", "--correction", "--cut_right"], None,
               "stdout.fq"),
    "stdout_merge": (PAIRS + ["--merge", "--stdout", "--cut_right", "-l",
                              "100", "--unpaired1", "u1.fq", "--unpaired2",
                              "u2.fq", "--failed_out", "f.fq"], None,
                     "stdout.fq"),
    "se_fasta": (["-i", "{r1}", "-o", "out.fq", "--adapter_fasta", "{fa}"],
                 None, None),
    "gap": (PAIRS + ["-o", "out1.fq", "-O", "out2.fq",
                     "--allow_gap_overlap_trimming", "--correction",
                     "--cut_right"], None, None),
    "pe251": (["-i", "{r1_251}", "-I", "{r2_251}", "-o", "out1.fq", "-O",
               "out2.fq"] + BENCH, None, None),
    "novaseq_pe": (PAIRS + ["-o", "out1.fq", "-O", "out2.fq"] + NOVASEQ, None,
                   None),
    "novaseq_se": (["-i", "{r1}", "-o", "out.fq"] + NOVASEQ, None, None),
}


def _interleave(r1, r2, path):
    with open(r1, "rb") as f1, open(r2, "rb") as f2:
        a, b = f1.read().splitlines(True), f2.read().splitlines(True)
    with open(path, "wb") as out:
        for k in range(0, len(a), 4):
            out.writelines(a[k:k + 4] + b[k:k + 4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (2,000 PE151 pairs, the same pairs interleaved, 1,000
    PE251 pairs, the FASTA) and fastp_tpu's run of every case."""
    d = tmp_path_factory.mktemp("modes")
    r1, r2 = make_corpus(d)
    paths = {"r1": r1, "r2": r2, "il": str(d / "interleaved.fq"),
             "fa": str(d / "adapters.fa"),
             "r1_251": str(d / "R1_251.fq"), "r2_251": str(d / "R2_251.fq")}
    _interleave(r1, r2, paths["il"])
    (d / "adapters.fa").write_text(FASTA)
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "1000", "--read-len", "251", "--seed", "11",
                    "--out1", paths["r1_251"], "--out2", paths["r2_251"]],
                   check=True, capture_output=True)
    cases = {name: ([a.format(**paths) for a in args],
                    stdin and stdin.format(**paths), stdout)
             for name, (args, stdin, stdout) in CASES.items()}

    def jax_run(name):
        args, stdin, stdout = cases[name]
        out = d / ("jax_" + name)
        out.mkdir()
        run_module("fastp_tpu", out, args, stdin=stdin, stdout=stdout)
        return name, out

    with ThreadPoolExecutor(4) as pool:
        jax_dirs = dict(pool.map(jax_run, cases))
    return cases, jax_dirs


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_fastp_tpu(runs, name, tmp_path):
    cases, jax_dirs = runs
    args, stdin, stdout = cases[name]
    run_module("fastp_tpu_torch", tmp_path, args, stdin=stdin, stdout=stdout)
    files = assert_same_outputs(tmp_path, jax_dirs[name])
    for f in files:   # every stream of the case carries reads
        assert os.path.getsize(tmp_path / f) > 0, f
    if stdout:
        assert stdout in files
    if name == "interleaved":   # the same pairs from two files
        two = tmp_path / "two_files"
        two.mkdir()
        i = args.index("--interleaved_in")
        run_module("fastp_tpu_torch", two,
                   ["-i", args[1].replace("interleaved.fq", "R1.fq"), "-I",
                    args[1].replace("interleaved.fq", "R2.fq")]
                   + args[i + 1:])
        assert assert_same_outputs(tmp_path, two) == files


def test_stdin_stdout_cfg1(tmp_path):
    run_module("fastp_tpu_torch", tmp_path, ["--stdin", "--stdout"], stdin=R1,
               stdout="out.fq")
    with open(tmp_path / "out.fq", "rb") as got, \
            open(os.path.join(GOLDENS, "cfg1_se_default", "out.fq"), "rb") as want:
        assert got.read() == want.read()
