"""The run accumulator of the port, and the two correction test hooks.

In accumulate mode (the default on one device) the sums of a batch -- every
stat_batch dict, the insert-size histogram, the correction matrix, the polyX
counts and the lean result histogram -- stay on the device, are added to a
resident int64 vector per batch width, and come to the host once, at the end
of the run.  FASTP_TPU_NO_ACCUM=1 fetches them with every batch, as the port
did before.  Both ways every path writes the same FASTQ and the same JSON
(exact equality: counts are integers):

* SE, the main PE path (bench flags), cfg8 flags (not lean), merging with
  --include_unmerged with and without the native library
  (FASTP_TPU_NO_NATIVE=1: the per-row loop counts the unmerged survivors
  itself, so nothing accumulates there);
* a run whose reads grow from 151 to 251 bases: a second chain starts at
  the wider batch;
* two jobs of two widths through one resident server: the second starts
  from zero;
* a run that dies drops its chains;
* FASTP_TPU_CORR_CAP=1 (every batch overflows its one correction slot and
  is recomputed on the host) against the default output and against
  `python -m fastp_tpu` with the same variable; FASTP_TPU_CORR_K is held in
  tests/test_torch_mesh.py.
"""
import os

import numpy as np
import pytest
import torch

from fastp_tpu_torch import client
from fastp_tpu_torch.cli import prepare_options
from fastp_tpu_torch.io import native as t_native
from fastp_tpu_torch.pipeline import device as t_device
from fastp_tpu_torch.pipeline import pe_runner as t_pe_runner
from fastp_tpu_torch.pipeline import runner as t_runner
from test_torch_cli import (BENCH, R1, R2, assert_same_outputs,
                            one_torch_thread, run_module)  # noqa: F401
from test_torch_mesh import _make_corpus, run_port
from test_torch_server import _job, _start_server, _stop

CASES = {
    "se": ["-o", "out.fq", "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"],
    "main": ["-o", "out1.fq", "-O", "out2.fq"] + BENCH,
    "cfg8": ["-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
             "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
             "--overlapped_out", "ov.fq", "-l", "100"],
    "merge": ["--merge", "--merged_out", "m.fq", "--include_unmerged",
              "-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
              "--trim_poly_x", "--dedup"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("accum")
    r1, r2 = _make_corpus(d, 700, 29)

    def args_of(name):
        inputs = ["-i", r1] + ([] if name == "se" else ["-I", r2])
        return inputs + CASES[name] + ["--batch_size", "256"]
    return args_of


def _fetched(fn):
    """(result of fn, transfers made, bytes moved) by the steps meanwhile."""
    before = dict(t_device.fetch_stats)
    res = fn()
    return (res, t_device.fetch_stats["fetches"] - before["fetches"],
            t_device.fetch_stats["bytes"] - before["bytes"])


@pytest.mark.parametrize("name,no_native", [
    ("se", False), ("main", False), ("cfg8", False), ("merge", False),
    ("merge", True), ("main", True)])
def test_accumulating_run_equals_per_batch_run(corpus, name, no_native,
                                               tmp_path):
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    res, fetches, moved = _fetched(
        lambda: run_port(tmp_path / "accum", corpus(name), **env))
    res0, fetches0, moved0 = _fetched(
        lambda: run_port(tmp_path / "per_batch", corpus(name),
                         FASTP_TPU_NO_ACCUM="1", **env))
    assert res["batches"] == res0["batches"] == 3 and fetches0 == 3
    assert_same_outputs(tmp_path / "accum", tmp_path / "per_batch")
    if name == "merge" and no_native:
        # the per-row loop stats the unmerged survivors on the host
        assert (fetches, moved) == (fetches0, moved0)
    else:
        # one more transfer, at the end, and fewer bytes with every batch
        assert fetches == 4 and moved < moved0


def test_merging_without_the_native_library_accumulates_nothing(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt = prepare_options(["fastp_tpu_torch", "-i", R1, "-I", R2, "--merge",
                           "--merged_out", "m.fq"])
    assert t_pe_runner.PairEndProcessor(opt, "cpu")._accum == (
        t_native.get_lib() is not None)
    monkeypatch.setenv("FASTP_TPU_NO_NATIVE", "1")
    assert t_native.get_lib() is None
    assert t_pe_runner.PairEndProcessor(opt, "cpu")._accum is False
    opt.merge.enabled = False
    assert t_pe_runner.PairEndProcessor(opt, "cpu")._accum is True
    # off on a split, and off when asked
    assert t_pe_runner.PairEndProcessor(opt, ["cpu", "cpu"])._accum is False
    monkeypatch.setenv("FASTP_TPU_NO_ACCUM", "1")
    assert t_pe_runner.PairEndProcessor(opt, "cpu")._accum is False


def _two_widths(d):
    """A PE corpus whose first 1,100 pairs have 151 bases and whose last 200
    have 251: the batch width grows in mid-run (the pre-pass that sizes the
    first batches reads 1,000 records)."""
    a1, a2 = _make_corpus(d, 1100, 31)
    os.rename(a1, d / "a1.fq")
    os.rename(a2, d / "a2.fq")
    b1, b2 = _make_corpus(d, 200, 37, "--read-len", "251")
    for short, long_ in ((d / "a1.fq", b1), (d / "a2.fq", b2)):
        with open(short, "rb") as f:
            head = f.read()
        with open(long_, "rb") as f:
            tail = f.read()
        with open(long_, "wb") as f:
            f.write(head + tail)
    return b1, b2


def test_a_wider_batch_starts_a_new_chain(tmp_path, monkeypatch):
    r1, r2 = _two_widths(tmp_path)
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq",
            "--batch_size", "256"] + BENCH
    chains = []
    real = t_runner.BaseProcessor._fold_accs

    def spy(self):
        chains.extend(sorted(self._acc_state))
        return real(self)

    monkeypatch.setattr(t_runner.BaseProcessor, "_fold_accs", spy)
    res = run_port(tmp_path / "accum", args)
    assert len(chains) == 2 and chains[0] < chains[1], chains
    run_port(tmp_path / "per_batch", args, FASTP_TPU_NO_ACCUM="1")
    assert_same_outputs(tmp_path / "accum", tmp_path / "per_batch")
    assert res["pre1"].reads == 1300
    assert res["pre1"].cycle_total_base[200] == 200   # only the long reads


def test_a_servers_second_job_starts_from_zero(tmp_path):
    """A PE251 job after a PE151 job in one resident server: each equals
    its own direct run (a chain carried over would add the first job's
    counts to the second's report).  The third job asks for --devices 2
    and runs there as it does directly: split, and not accumulating."""
    short = _make_corpus(tmp_path, 300, 41)
    os.rename(short[0], tmp_path / "s1.fq")
    os.rename(short[1], tmp_path / "s2.fq")
    long_ = _make_corpus(tmp_path, 300, 43, "--read-len", "251")
    jobs = {"short": [str(tmp_path / "s1.fq"), str(tmp_path / "s2.fq")],
            "long": list(long_), "short_again": [str(tmp_path / "s1.fq"),
                                                 str(tmp_path / "s2.fq")]}
    flags = ["-o", "out1.fq", "-O", "out2.fq", "--batch_size", "256"] + BENCH
    sock = str(tmp_path / "s.sock")
    proc, line = _start_server(tmp_path, sock)
    try:
        assert line.startswith("READY"), line + proc.stderr.read()[-3000:]
        for name, (r1, r2) in jobs.items():
            split = ["--devices", "2"] if name == "short_again" else []
            res = _job(tmp_path / ("served_" + name),
                       ["-i", r1, "-I", r2] + flags + split, sock)
            assert res.returncode == 0, res.stderr[-3000:]
            assert (b"2 shards of every batch: cpu, cpu" in res.stderr) \
                == bool(split)
        assert client.ping(sock)["jobs"] == 3
    finally:
        _stop(proc, sock)
    for name, (r1, r2) in jobs.items():
        run_port(tmp_path / ("direct_" + name), ["-i", r1, "-I", r2] + flags,
                 FASTP_TPU_NO_ACCUM="1")
        assert_same_outputs(tmp_path / ("served_" + name),
                            tmp_path / ("direct_" + name))


def test_a_run_that_dies_drops_its_chains(corpus, tmp_path, monkeypatch):
    real = t_pe_runner.PairEndProcessor._process_batch
    seen = {}

    def second_batch_fails(self, item):
        if item.start:
            seen["proc"], seen["chains"] = self, len(self._acc_state)
            raise RuntimeError("batch failed")
        return real(self, item)

    monkeypatch.setattr(t_pe_runner.PairEndProcessor, "_process_batch",
                        second_batch_fails)
    with pytest.raises(RuntimeError, match="batch failed"):
        run_port(tmp_path, corpus("main"))
    assert seen["chains"] == 1 and seen["proc"]._acc_state == {}


def test_the_accumulator_counts_in_int64(tmp_path, monkeypatch):
    """A chain that has passed 2**31 keeps counting (the histogram-width
    trap of an int32 accumulator)."""
    monkeypatch.chdir(tmp_path)
    opt = prepare_options(["fastp_tpu_torch", "-i", R1, "-o", "out.fq"])
    proc = t_runner.SingleEndProcessor(opt, "cpu")
    big = 2 ** 31 + 5

    def run(*args):
        return t_device.StepOut(
            {"pre": {"reads": torch.tensor(big, dtype=torch.int64)},
             "polyx_reads": torch.full((4,), 2 ** 30, dtype=torch.int32),
             "rlen": torch.zeros(2, dtype=torch.int32)}, rows=2, width=32)

    twice = t_device.Step(run, proc.step.io)
    args = (np.zeros((2, 32), np.uint8),)
    for _ in range(4):
        out = proc._call_step(twice, args).wait()
        assert set(out) == {"rlen"}
    (vals,) = proc._fold_accs()
    assert vals["pre"]["reads"].dtype == np.int64
    assert int(vals["pre"]["reads"]) == 4 * big
    assert vals["polyx_reads"].tolist() == [2 ** 32] * 4
    assert proc._fold_accs() == []


def test_corr_cap_forces_the_overflow_path(corpus, tmp_path, monkeypatch):
    """FASTP_TPU_CORR_CAP=1: one correction slot, so every batch with two
    corrections overflows and is recomputed on the host; the outputs are
    the default's, and fastp_tpu's under the same variable."""
    real = t_pe_runner.PairEndProcessor._host_correct_all
    overflowed = []

    def counting(self, batch1, batch2, out, B, rows=None):
        overflowed.append((out["c1_rows"].shape[0], int(out["c1_count"])))
        return real(self, batch1, batch2, out, B, rows=rows)

    monkeypatch.setattr(t_pe_runner.PairEndProcessor, "_host_correct_all",
                        counting)
    res = run_port(tmp_path / "default", corpus("main"))
    assert overflowed == [] and res["corr_overflow_batches"] == 0
    res = run_port(tmp_path / "cap", corpus("main"), FASTP_TPU_CORR_CAP="1")
    assert res["corr_overflow_batches"] == 3
    assert len(overflowed) == 3 and all(c == 1 and n > 1
                                        for c, n in overflowed)
    assert_same_outputs(tmp_path / "cap", tmp_path / "default")
    (tmp_path / "jax").mkdir()
    run_module("fastp_tpu", tmp_path / "jax", corpus("main"),
               FASTP_TPU_CORR_CAP="1")
    assert_same_outputs(tmp_path / "cap", tmp_path / "jax")
