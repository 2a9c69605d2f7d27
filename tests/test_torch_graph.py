"""The step kept per configuration and, on a card, replayed as a CUDA graph
(fastp_tpu_torch/pipeline/device.py: memo_step, Step, _Graph).

On the CPU: the memo (one Step per key, a new one for each environment
variable a step reads, at most sixteen entries, a second run that starts
from zero), the port's PE and SE steps against fastp_tpu's with the count
of valid rows going up as an array (240, 100 and 0 of 256 rows), and the
kernels' launches counted per replay of a graph, through a stand-in for
the graph.  On a card (marker `cuda`, skipped here): the graph against
the eager step, every key, a partial batch after a full one, and two
shards of a split on one device.
"""
import collections
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from fastp_tpu.pipeline import device as j_device
from fastp_tpu_torch import cli
from fastp_tpu_torch.ops import launches
from fastp_tpu_torch.parallel import mesh as t_mesh
from fastp_tpu_torch.pipeline import device as t_device
from test_torch_cli import GOLDENS, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_cli import R1, R2, assert_same_outputs
from test_torch_step import BENCH, _cfg, _compare, _synth_batch

os.environ.setdefault("OMP_NUM_THREADS", "1")


@pytest.fixture
def memo(monkeypatch):
    """An empty memo for the test, the process's own put back after it."""
    fresh = collections.OrderedDict()
    monkeypatch.setattr(t_device, "_memo", fresh)
    return fresh


@pytest.fixture(scope="module")
def bench_cfg(tmp_path_factory):
    return _cfg(BENCH, True, tmp_path=tmp_path_factory.mktemp("graph"))


@pytest.fixture(scope="module")
def se_cfg(tmp_path_factory):
    return _cfg(BENCH[2:4], True, paired=False,
                tmp_path=tmp_path_factory.mktemp("graph_se"))


def test_the_same_key_gives_the_same_step(memo, bench_cfg):
    step = t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu")
    assert t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu") is step
    p3 = t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu",
                            packed="p3")
    assert p3 is not step and step.entry.step("p3") is p3
    assert p3.io is step.io and len(memo) == 1
    assert not step.graph        # the CPU has no CUDA graph
    rowwise = t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu",
                                 rowwise=True)
    se = t_device.memo_step(t_device.build_se_step, bench_cfg, "cpu")
    assert len({id(step), id(rowwise), id(se)}) == 3 and len(memo) == 3


@pytest.mark.parametrize("var", t_device.STEP_ENV)
def test_each_variable_a_step_reads_gives_a_step_of_its_own(
        var, memo, bench_cfg, monkeypatch):
    monkeypatch.delenv(var, raising=False)
    plain = t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu")
    monkeypatch.setenv(var, "1")
    own = t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu")
    assert own is not plain and own.io is not plain.io
    assert t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu") is own
    monkeypatch.delenv(var)
    assert t_device.memo_step(t_device.build_pe_step, bench_cfg, "cpu") is plain


def test_the_memo_keeps_the_sixteen_latest(memo, bench_cfg):
    cfgs = [dataclasses.replace(bench_cfg, insert_size_max=272 + k)
            for k in range(t_device.MEMO_ENTRIES + 1)]
    first = t_device.memo_step(t_device.build_se_step, cfgs[0], "cpu")
    second = t_device.memo_step(t_device.build_se_step, cfgs[1], "cpu")
    assert t_device.memo_step(t_device.build_se_step, cfgs[0], "cpu") is first
    for cfg in cfgs[2:]:
        t_device.memo_step(t_device.build_se_step, cfg, "cpu")
    assert len(memo) == t_device.MEMO_ENTRIES == 16
    # cfgs[1] was the least recently used: gone; cfgs[0] was used again
    assert t_device.memo_step(t_device.build_se_step, cfgs[0], "cpu") is first
    assert t_device.memo_step(t_device.build_se_step, cfgs[1], "cpu") \
        is not second


def test_a_second_run_shares_the_step_and_starts_from_zero(memo, tmp_path,
                                                          monkeypatch):
    """Two jobs of one configuration in one process (as a resident server
    runs them): one memo entry, the same Step, and the second job's
    counts are its own, equal to the golden's."""
    args = ["fastp_tpu_torch", "-i", R1, "-I", R2, "-o", "out1.fq", "-O",
            "out2.fq", "--correction", "--cut_right"]
    results, steps = [], []
    for k in range(2):
        d = tmp_path / str(k)
        d.mkdir()
        monkeypatch.chdir(d)
        results.append(cli.run(args, device="cpu"))
        steps.append([e.steps[False] for e in memo.values()])
        assert_same_outputs(d, os.path.join(GOLDENS, "cfg3_pe_correction"))
    assert len(memo) == 1 and steps[0][0] is steps[1][0]
    assert results[1]["pre1"].reads == results[0]["pre1"].reads > 0
    assert results[1]["batches"] == results[0]["batches"]


def _jax_out(build, cfg, args):
    step_j = build(cfg)
    return j_device.unpack_from_host(jax.device_get(step_j(*args)),
                                     step_j.layout)


@pytest.mark.parametrize("nvalid", [240, 100, 0])
@pytest.mark.parametrize("paired", [True, False], ids=["pe", "se"])
def test_step_matches_jax_at_every_valid_count(paired, nvalid, bench_cfg,
                                               se_cfg):
    """The valid rows' count goes up as an array (make_aux's int32) and
    the mask is made on the device: a batch with fewer valid rows than the
    last one reads its own count."""
    cfg = bench_cfg if paired else se_cfg
    batch = _synth_batch(31, nvalid=nvalid)
    if not paired:
        batch = batch[:3]
    aux = t_device.make_aux(cfg, nvalid)
    assert isinstance(aux[-1], np.int32) and aux[-1] == nvalid
    build = t_device.build_pe_step if paired else t_device.build_se_step
    jbuild = j_device.build_pe_step if paired else j_device.build_se_step
    want = _jax_out(jbuild, cfg, (*batch, *j_device.make_aux(cfg, nvalid)))
    step = build(cfg, "cpu")
    _compare(step(*batch, *aux), want)
    # the same Step on a batch with another count: its own mask again
    other = 240 if nvalid != 240 else 100
    batch2 = _synth_batch(31, nvalid=other)[:len(batch)]
    _compare(step(*batch2, *t_device.make_aux(cfg, other)),
             _jax_out(jbuild, cfg, (*batch2, *j_device.make_aux(cfg, other))))


class _StandInGraph:
    """Stands in for pipeline/device.py:_Graph on the CPU: its warm-up runs
    and its capture each count two overlap_sweep and four stat_batch
    launches inside launches.uncounted(), and it takes what the capture
    tallied as the launches the graph holds; a replay runs nothing.  Every
    instance is kept in `made`."""

    made = []

    def __init__(self, step, arrays, accum, key):
        self.key = key
        with launches.uncounted() as tally:
            for _ in range(t_device.GRAPH_WARMUPS):
                self._launch()
            self.warm = dict(tally)
            tally.update(launches.zero_tally())
            self._launch()                   # the capture
            self.launches = dict(tally)
        self.out = t_device.StepOut({}, rows=arrays[0].shape[0])
        self.graph = self
        self.loads = self.replays = 0
        _StandInGraph.made.append(self)

    @staticmethod
    def _launch():
        for name in ("overlap_sweep",) * 2 + ("stat_batch",) * 4:
            launches.count(name)

    def load(self, io, arrays):
        self.loads += 1

    def replay(self):
        self.replays += 1


def test_launches_count_per_replay_and_not_at_capture(monkeypatch,
                                                        bench_cfg):
    monkeypatch.setattr(t_device, "_Graph", _StandInGraph)
    _StandInGraph.made = []
    step = t_device.build_pe_step(bench_cfg, "cpu")
    step.graph = True                 # the graph path, with the stand-in
    args = (np.zeros((8, 32), np.uint8), np.zeros(8, np.int16), np.int32(8))
    before = launches.snapshot()
    for _ in range(5):
        step.run(*args, accum=True)
    # warm-ups and the capture count nothing; each replay counts its kernels
    assert launches.since(before) == {"overlap_sweep": 10,
                                      "overlap_gap_sweep": 0, "stat_batch": 20,
                                      "trim_by_sequence": 0}
    (g,) = _StandInGraph.made
    assert g.warm == {"overlap_sweep": 2 * t_device.GRAPH_WARMUPS,
                      "overlap_gap_sweep": 0,
                      "stat_batch": 4 * t_device.GRAPH_WARMUPS,
                      "trim_by_sequence": 0}
    assert g.launches == {"overlap_sweep": 2, "overlap_gap_sweep": 0,
                          "stat_batch": 4, "trim_by_sequence": 0}
    assert g.replays == 5 and g.loads == 4   # the first batch loads at capture
    # another shape, accum or shard is another graph
    step.run(np.zeros((16, 32), np.uint8), np.zeros(16, np.int16),
             np.int32(9), accum=True)
    step.run(*args, accum=False)
    step.run(*args, accum=True, shard=1)
    assert len(_StandInGraph.made) == 4
    assert launches.since(before)["overlap_sweep"] == 16
    assert launches.since(before)["stat_batch"] == 32
    # outside uncounted() a launch counts at once
    launches.count("trim_by_sequence")
    assert launches.since(before)["trim_by_sequence"] == 1


def test_a_shard_runs_with_its_index():
    """Shards on one device share a Step: each runs with its index, which
    gives it a graph (and static outputs) of its own."""
    seen = []

    class Probe:
        def run(self, *args, shard=0):
            seen.append((shard, int(args[-1])))

    probe = Probe()
    split = t_mesh.ShardedStep([probe, probe], 3)
    args = (np.zeros((8, 4)), np.zeros((8, 4)), np.zeros(8), np.int32(5))
    split.run(*args)
    assert seen == [(0, 4), (1, 1)]
    with pytest.raises(ValueError, match="joined on the host"):
        split.run(*args, accum=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")


def _accumulated(step, args):
    """One batch as the batch loop queues it in accumulate mode, fetched
    with its sums put back."""
    with step.on_stream():
        out = step.run(*args, accum=True)
        sums = t_device.unpack_acc(step.fetch_vector(out.delta), out.acc_meta)
        got = step.start_fetch(out).wait()
    got.update(sums)
    return got


def _bit_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _bit_equal(got[k], w)
        else:
            g, w = np.asarray(got[k]), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False], ids=["pe", "se"])
def test_graph_matches_eager_on_card(paired, bench_cfg, se_cfg):
    _card()
    cfg = bench_cfg if paired else se_cfg
    build = t_device.build_pe_step if paired else t_device.build_se_step
    graph, eager = build(cfg, "cuda"), build(cfg, "cuda", graph=False)
    assert graph.graph and not eager.graph
    for nvalid in (256, 100, 240):   # a full batch, then partial ones
        batch = _synth_batch(nvalid, B=256, nvalid=nvalid)
        if not paired:
            batch = batch[:3]
        args = (*batch, *t_device.make_aux(cfg, nvalid))
        _bit_equal(_accumulated(graph, args), _accumulated(eager, args))
        _bit_equal(graph(*args), eager(*args))


@pytest.mark.cuda
def test_two_shards_on_one_card_keep_their_own_outputs(bench_cfg):
    _card()
    devices = [torch.device("cuda", 0)] * 2
    graph = t_mesh.build_sharded_step(t_device.build_pe_step, bench_cfg,
                                      devices)
    eager = t_mesh.build_sharded_step(
        functools.partial(t_device.build_pe_step, graph=False), bench_cfg,
        devices)
    assert graph.steps[0] is graph.steps[1] and graph.steps[0].graph
    for nvalid in (256, 200):
        batch = _synth_batch(nvalid + 1, B=256, nvalid=nvalid)
        args = (*batch, *t_device.make_aux(bench_cfg, nvalid))
        _bit_equal(graph(*args), eager(*args))
