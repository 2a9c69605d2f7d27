"""The pipelined batch loop of the port (pipeline/runner.py:_run_batches):
produce() ahead on a prep worker, one dispatch worker, fetch workers, the
calling thread consuming in input order.  Everything is integers and bytes:
every comparison is exact.

* FASTQ byte for byte and JSON equal to `python -m fastp_tpu` at
  FASTP_TPU_PREFETCH 1, 2, 3 and 5, on a 700-pair tools/make_synth.py corpus
  read in batches of 128 (six batches), for the bench flags, cfg1, cfg8,
  cfg5 and the bench flags with --devices 2; with one fetch worker;
* --reads_to_process ending inside a batch, SE and PE, against fastp_tpu;
* the rows sampled for the overrepresentation analysis are every
  `sampling`-th read of the INPUT, whatever the batch size and however far
  produce() runs ahead, and the report equals fastp_tpu's;
* an exception raised in produce(), in the dispatch worker or in a fetch
  worker ends the run with that exception and leaves no thread behind;
* _batch_stream calls produce() at most `depth` times past the end of the
  input, and those calls submit nothing;
* the transfer counters lose no update under 32 threads;
* the FASTP_TPU_TIMING lines have fastp_tpu's format (SE: with `reads=`);
  FASTP_TPU_CPUPROFILE and FASTP_TPU_PROFILE leave their files.
"""
import os
import pstats
import re
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fastp_tpu_torch.pipeline import device as t_device
from fastp_tpu_torch.pipeline import pe_runner as t_pe_runner
from fastp_tpu_torch.pipeline import runner as t_runner
from test_torch_cli import (BENCH, assert_same_outputs, one_torch_thread,
                            run_module)  # noqa: F401
from test_torch_mesh import CORPUS_CASES, _make_corpus, run_port

OUT2 = ["-o", "out1.fq", "-O", "out2.fq"]
CASES = {
    "bench": OUT2 + BENCH,
    "cfg1": CORPUS_CASES["cfg1"],
    "cfg8": CORPUS_CASES["cfg8"],
    "cfg5": CORPUS_CASES["cfg5"],
    "devices2": OUT2 + BENCH + ["--devices", "2"],
    # the read limit falls inside the third batch
    "limit_pe": OUT2 + BENCH + ["--reads_to_process", "300"],
    "limit_se": ["-o", "out.fq", "--reads_to_process", "300"],
    # every 7th read, in batches of 128: the sampled rows of a batch depend
    # on where the batch starts
    "overrep": OUT2 + ["--overrepresentation_analysis",
                       "--overrepresentation_sampling", "7"],
}
SE_CASES = ("cfg1", "limit_se")
BATCH = ["--batch_size", "128"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, the arguments of every case and fastp_tpu's run of it
    (--devices 2 compares with fastp_tpu on one device: a split changes no
    byte)."""
    d = tmp_path_factory.mktemp("pipeline")
    r1, r2 = _make_corpus(d, 700, 53)

    def args_of(name):
        inputs = ["-i", r1] + ([] if name in SE_CASES else ["-I", r2])
        return inputs + CASES[name] + BATCH

    def jax_run(name):
        out = d / ("jax_" + name)
        out.mkdir()
        args = [a for a in args_of(name) if a not in ("--devices", "2")]
        run_module("fastp_tpu", out, args)
        return name, out

    with ThreadPoolExecutor(4) as pool:
        jax_dirs = dict(pool.map(jax_run, CASES))
    return args_of, jax_dirs


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("name", ["bench", "cfg1", "cfg8", "cfg5",
                                  "devices2"])
def test_prefetch_depth_changes_no_byte(corpus, name, depth, tmp_path):
    args_of, jax_dirs = corpus
    res = run_port(tmp_path, args_of(name), FASTP_TPU_PREFETCH=str(depth))
    assert res["batches"] == 6
    files = assert_same_outputs(tmp_path, jax_dirs[name])
    for f in files:
        assert os.path.getsize(tmp_path / f) > 0, f


def test_one_fetch_worker_changes_no_byte(corpus, tmp_path):
    args_of, jax_dirs = corpus
    run_port(tmp_path, args_of("bench"), FASTP_TPU_FETCH_WORKERS="1")
    assert_same_outputs(tmp_path, jax_dirs["bench"])


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("name", ["limit_pe", "limit_se"])
def test_read_limit_inside_a_batch(corpus, name, depth, tmp_path):
    args_of, jax_dirs = corpus
    res = run_port(tmp_path, args_of(name), FASTP_TPU_PREFETCH=str(depth))
    assert res["batches"] == 3
    pre = res["pre" if name == "limit_se" else "pre1"]
    assert pre.reads == 300
    assert_same_outputs(tmp_path, jax_dirs[name])


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_overrep_sampling_counts_reads_of_the_input(corpus, depth, tmp_path,
                                                    monkeypatch):
    args_of, jax_dirs = corpus
    sampled = []
    real_stat = t_runner._OverRepCounter.stat_rows
    real_batch = t_pe_runner.PairEndProcessor._process_batch
    starts = []

    def spy_batch(self, item):
        starts.append(item.start)
        return real_batch(self, item)

    def spy_stat(self, bases, start, rlen, rows):
        if self is getattr(spy_stat, "pre1", None):
            sampled.extend((starts[-1] + np.asarray(rows)).tolist())
        return real_stat(self, bases, start, rlen, rows)

    real_init = t_pe_runner.PairEndProcessor.__init__

    def spy_init(self, *a, **k):
        real_init(self, *a, **k)
        spy_stat.pre1 = self.overrep_pre1

    monkeypatch.setattr(t_pe_runner.PairEndProcessor, "__init__", spy_init)
    monkeypatch.setattr(t_pe_runner.PairEndProcessor, "_process_batch",
                        spy_batch)
    monkeypatch.setattr(t_runner._OverRepCounter, "stat_rows", spy_stat)
    run_port(tmp_path, args_of("overrep"), FASTP_TPU_PREFETCH=str(depth))
    assert starts == list(range(0, 700, 128))
    if spy_stat.pre1.enabled:   # the pre-pass found candidate sequences
        assert sampled == list(range(0, 700, 7))
    assert_same_outputs(tmp_path, jax_dirs["overrep"])


# ---------------------------------------------------------------------------
# failures


def _threads_now():
    """threading.active_count() once the short-lived threads that zero the
    released duplicate-filter buffers (duplicate.py: rezero) have ended:
    they belong to no pool and end by themselves."""
    for t in threading.enumerate():
        if "(rezero)" in t.name:
            t.join(timeout=120)
    return threading.active_count()


def _second_call_fails(real, message):
    calls = []

    def fn(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError(message)
        return real(*a, **k)
    return fn


@pytest.mark.parametrize("where", ["produce", "dispatch", "fetch"])
@pytest.mark.parametrize("depth", [1, 3])
def test_a_workers_exception_ends_the_run(corpus, where, depth, tmp_path,
                                          monkeypatch):
    args_of, _ = corpus
    cls = t_pe_runner.PairEndProcessor
    message = "failed in " + where
    if where == "produce":      # the index filter is a step of produce()
        monkeypatch.setattr(cls, "_index_drop_mask_batches",
                            _second_call_fails(cls._index_drop_mask_batches,
                                               message))
    elif where == "dispatch":
        monkeypatch.setattr(cls, "_dispatch_pe",
                            _second_call_fails(cls._dispatch_pe, message))
    else:
        monkeypatch.setattr(t_device.PendingFetch, "wait",
                            _second_call_fails(t_device.PendingFetch.wait,
                                               message))
    procs = []
    real_init = cls.__init__

    def spy_init(self, *a, **k):
        real_init(self, *a, **k)
        procs.append(self)

    monkeypatch.setattr(cls, "__init__", spy_init)
    before = _threads_now()
    with pytest.raises(RuntimeError, match=message):
        run_port(tmp_path, args_of("bench"), FASTP_TPU_PREFETCH=str(depth))
    assert _threads_now() == before, threading.enumerate()
    (proc,) = procs
    assert proc._pools == {} and proc._acc_state == {}
    assert proc.batches == 1    # the first batch was written, no later one


def test_abandon_reports_what_it_could_not_close(corpus, tmp_path,
                                                 monkeypatch, capsys):
    """When ending the workers fails too, the job still ends with its own
    exception, the failure is named on stderr, and the rest of the clean-up
    (writers, accumulator) is done."""
    args_of, _ = corpus
    cls = t_pe_runner.PairEndProcessor
    monkeypatch.setattr(cls, "_dispatch_pe",
                        _second_call_fails(cls._dispatch_pe, "the job's own"))
    real_close = cls._close_pool
    procs = []

    def failing_close(self):
        procs.append(self)
        real_close(self)
        raise OSError("shutdown failed")

    monkeypatch.setattr(cls, "_close_pool", failing_close)
    before = _threads_now()
    with pytest.raises(RuntimeError, match="the job's own"):
        run_port(tmp_path, args_of("bench"))
    err = capsys.readouterr().err
    assert "closing the workers failed" in err and "shutdown failed" in err
    assert _threads_now() == before, threading.enumerate()
    assert procs[0]._acc_state == {}


def test_a_finished_run_leaves_no_thread(corpus, tmp_path):
    args_of, _ = corpus
    before = _threads_now()
    run_port(tmp_path, args_of("bench"))
    assert _threads_now() == before, threading.enumerate()


def test_transfer_counters_lose_no_update():
    """fetch_stats is added to by the dispatch worker, the fetch workers and
    the calling thread: 32 threads on a shortened switch interval lose no
    update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = dict(t_device.fetch_stats)

        def add():
            for _ in range(2000):
                t_device._count("fetch", 3)
                t_device._count("upload", 5)

        with ThreadPoolExecutor(32) as pool:
            for f in [pool.submit(add) for _ in range(32)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    moved = {k: v - before[k] for k, v in t_device.fetch_stats.items()}
    assert moved == {"fetches": 64000, "bytes": 192000, "uploads": 64000,
                     "upload_bytes": 320000}


# ---------------------------------------------------------------------------
# _batch_stream


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_batch_stream_overshoots_by_depth_at_most(corpus, depth, tmp_path,
                                                  monkeypatch):
    """Direct: four items, then None for ever.  And in a run: as many
    submissions and dispatches as batches, however deep the prefetch."""
    monkeypatch.chdir(tmp_path)
    args_of, _ = corpus
    from fastp_tpu_torch.cli import prepare_options
    opt = prepare_options(["fastp_tpu_torch"] + args_of("cfg1"))
    proc = t_runner.SingleEndProcessor(opt, "cpu")
    calls = []

    def produce():
        calls.append(threading.current_thread().name)
        return len(calls) if len(calls) <= 4 else None

    assert list(proc._batch_stream(produce, depth)) == [1, 2, 3, 4]
    assert 5 <= len(calls) <= 4 + depth
    assert all(name.startswith("fastp_prep") for name in calls)
    proc._close_pool()

    submitted, dispatched = [], []
    real_submit = t_pe_runner.PairEndProcessor._submit_batch
    real_dispatch = t_pe_runner.PairEndProcessor._dispatch_pe
    monkeypatch.setattr(
        t_pe_runner.PairEndProcessor, "_submit_batch",
        lambda self, *a: submitted.append(1) or real_submit(self, *a))
    monkeypatch.setattr(
        t_pe_runner.PairEndProcessor, "_dispatch_pe",
        lambda self, *a: dispatched.append(threading.current_thread().name)
        or real_dispatch(self, *a))
    res = run_port(tmp_path, args_of("bench"), FASTP_TPU_PREFETCH=str(depth))
    assert res["batches"] == len(submitted) == len(dispatched) == 6
    assert set(dispatched) == {"fastp_upload_0"}   # one worker, in order


def test_prefetch_is_at_least_one(corpus, tmp_path):
    args_of, jax_dirs = corpus
    run_port(tmp_path, args_of("cfg1"), FASTP_TPU_PREFETCH="0")
    assert_same_outputs(tmp_path, jax_dirs["cfg1"])


# ---------------------------------------------------------------------------
# the switches

# the three lines of fastp_tpu/pipeline/pe_runner.py's FASTP_TPU_TIMING
_SEC = r"\d+\.\d\ds"
TIMING = (
    r"TIMING produce=%s fetch_wait=%s route=%s flush=%s {unit}=(\d+) "
    r"\[read=%s dup=%s pad=%s submit=%s\]\n"
    r"TIMING workers dispatch=%s device_get=%s\n"
    r"TIMING cpu user=%s sys=%s wall=%s minflt=\d+ majflt=\d+\n"
    % ((_SEC,) * 13))


@pytest.mark.parametrize("name,unit", [("bench", "pairs"), ("cfg5", "pairs"),
                                       ("cfg1", "reads")])
def test_timing_lines(corpus, name, unit, tmp_path, capfd):
    args_of, _ = corpus
    run_port(tmp_path, args_of(name), FASTP_TPU_TIMING="1")
    err = capfd.readouterr().err
    found = re.findall(TIMING.format(unit=unit), err)
    assert found == ["700"], err[-2000:]
    run_port(tmp_path, args_of(name))
    assert "TIMING" not in capfd.readouterr().err


def test_cpuprofile_and_trace(corpus, tmp_path):
    args_of, jax_dirs = corpus
    prof, trace = str(tmp_path / "loop.prof"), str(tmp_path / "trace")
    run_port(tmp_path / "run", args_of("bench"), FASTP_TPU_CPUPROFILE=prof,
             FASTP_TPU_PROFILE=trace)
    assert_same_outputs(tmp_path / "run", jax_dirs["bench"])
    names = {fn[2] for fn in pstats.Stats(prof).stats}
    assert "_process_batch" in names and "_run_batches" in names
    (written,) = os.listdir(trace)
    with open(os.path.join(trace, written)) as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::" in text
