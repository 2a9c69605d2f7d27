"""`--devices N` in the port: the step split over N devices by hand.

On the CPU a split is N shards of the CPU, so everything but the cards is
exercised here.  Integers throughout: every comparison is exact.

* ops.correct.extract_deltas against fastp_tpu.ops.correct.extract_deltas
  on seeded masks (empty rows, rows with exactly K and with more than K set
  positions; K = 1 and 12; L = 160 and 251);
* parallel.mesh.pad_to_multiple against the reference's;
* the split step (parallel.mesh.build_sharded_step) against the port's
  unsplit step, key by key after the join, for N = 2 and 3: 256 rows (with
  N = 2 a shard has 128 rows, the length of the quality histogram: a join
  that told leaves apart by shape would concatenate it), 2048 rows (1024-row
  shards, the 5-mer histogram's used length) and a row count that N does not
  divide, padded by pad_to_multiple; PE lean and not, SE, merging.  The
  per-row correction deltas (c1k_*, c2k_*) are held against the JAX step
  built with mega="sharded", and against the unsplit step's sparse list;
* the CLI with `device="cpu"`: --devices 2 and 3 against --devices 1, FASTQ
  and JSON, for the cfg1, cfg2 and cfg3 goldens and for cfg1, cfg2, cfg3,
  cfg5 and cfg8 flags on a 700-pair tools/make_synth.py corpus in batches of
  256 (86-row shards of a 258-row batch with N = 3); with FASTP_TPU_CORR_K=1
  (rows over K take the host's recomputation); with --dedup and
  --filter_by_index1; and once against `python -m fastp_tpu --devices 2`;
* the rule of make_mesh: what --devices 0 means, a count above the cards
  raising, comma lists, and the indexed device --local_processes hands on.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fastp_tpu.ops import correct as j_correct
from fastp_tpu.parallel import mesh as j_mesh
from fastp_tpu.pipeline import device as j_device
from fastp_tpu_torch import cli
from fastp_tpu_torch.ops import correct as t_correct
from fastp_tpu_torch.parallel import mesh as t_mesh
from fastp_tpu_torch.pipeline import device as t_device
from fastp_tpu_torch.pipeline import pe_runner as t_pe_runner
from test_torch_cli import (GOLDENS, R1, R2, ROOT, assert_same_outputs,
                            one_torch_thread, run_module)  # noqa: F401
from test_torch_step import CONFIGS, SE_CONFIGS, _cfg, _compare, _synth_batch


# ---------------------------------------------------------------------------
# extract_deltas, pad_to_multiple


def _delta_rows(seed, K, B=64, L=160):
    """A mask whose rows hold 0, 1, K-1, K, K+1, 2K+3 and random numbers of
    set positions, with byte planes to take the deltas from."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), bool)
    counts = [0, 1, max(K - 1, 0), K, K + 1, 2 * K + 3]
    for i in range(B):
        n = counts[i] if i < len(counts) else int(rng.integers(0, 2 * K + 2))
        mask[i, rng.choice(L, size=min(n, L), replace=False)] = True
    mask[6, :] = False           # an empty row between full ones
    mask[7, L - 1] = True        # the last column, which the sentinel reads
    seq = rng.integers(0, 256, (B, L)).astype(np.uint8)
    qual = rng.integers(0, 256, (B, L)).astype(np.uint8)
    return mask, seq, qual


@pytest.mark.parametrize("L", [160, 251])
@pytest.mark.parametrize("K", [1, 12])
def test_extract_deltas_matches_jax(K, L):
    mask, seq, qual = _delta_rows(K * 1000 + L, K, L=L)
    want = j_correct.extract_deltas(mask, seq, qual, K)
    got = t_correct.extract_deltas(*(torch.from_numpy(x)
                                     for x in (mask, seq, qual)), K)
    for name, g, w in zip(("pos", "base", "qual", "count"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), name
    pos, count = got[0].numpy(), got[3].numpy()
    assert (count == 0).any() and (count == K).any() and (count > K).any()
    # ascending positions, L as the sentinel of every unused slot
    used = np.arange(K)[None, :] < np.minimum(count, K)[:, None]
    assert (pos[~used] == L).all() and (pos[used] < L).all()
    assert (np.diff(pos, axis=1) >= 0).all()


@pytest.mark.parametrize("n,batch", [(2, 256), (3, 256), (3, 250), (4, 7),
                                     (8, 8)])
def test_pad_to_multiple_matches_reference(n, batch):
    rng = np.random.default_rng(batch)
    arrays = [rng.integers(0, 255, (batch, 40)).astype(np.uint8),
              rng.integers(0, 40, batch).astype(np.int32),
              rng.random(batch) < 0.5]
    want = j_mesh.pad_to_multiple(arrays, n, batch)
    got = t_mesh.pad_to_multiple(arrays, n, batch)
    assert got[2] == want[2] and got[2] % n == 0
    assert np.array_equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the split step against the unsplit step


def _split_batch(seed, rows, nvalid, n, paired=True):
    """A synthetic batch of `rows` rows (the last rows - nvalid of them
    padding), padded by pad_to_multiple so that n divides it."""
    batch = _synth_batch(seed, B=rows, nvalid=nvalid)
    batch, valid, padded = t_mesh.pad_to_multiple(batch, n, rows)
    assert padded % n == 0 and len(valid) == padded
    return (batch if paired else batch[:3]), padded


PER_ROW_LISTS = {"c1_rows", "c1_pos", "c1_base", "c1_qual", "c1_count",
                 "c2_rows", "c2_pos", "c2_base", "c2_qual", "c2_count"}
PER_ROW_DELTAS = {"c1k_pos", "c1k_u8", "c1k_cnt", "c2k_pos", "c2k_u8",
                  "c2k_cnt"}


def _deltas_of_sparse_list(out, side):
    """{(row, pos): (base, qual)} from the unsplit step's sparse list."""
    n = int(out[side + "_count"])
    assert n <= len(out[side + "_rows"])
    return {(int(r), int(p)): (int(b), int(q)) for r, p, b, q in zip(
        out[side + "_rows"][:n], out[side + "_pos"][:n],
        out[side + "_base"][:n], out[side + "_qual"][:n])}


def _deltas_of_rows(out, side):
    """The same from the split step's per-row matrices."""
    K = out[side + "k_pos"].shape[0]
    cnt = out[side + "k_cnt"]
    assert (cnt <= K).all()      # no row of the synthetic batch overflows 12
    res = {}
    for row in np.flatnonzero(cnt):
        for k in range(int(cnt[row])):
            res[(int(row), int(out[side + "k_pos"][k, row]))] = (
                int(out[side + "k_u8"][k, row]),
                int(out[side + "k_u8"][K + k, row]))
    return res


PE_SPLIT_CASES = [
    # name, lean, N, rows, nvalid
    ("bench", True, 2, 256, 240),
    ("bench", False, 2, 256, 240),
    ("bench", True, 3, 256, 240),        # 258 rows after padding
    ("bench", False, 3, 250, 250),       # 252 rows, no padding before
    ("bench", True, 2, 2048, 2000),      # 1024-row shards
    ("cfg8", False, 2, 256, 100),        # a whole shard of padding
    ("cfg8", False, 3, 256, 240),
    ("merge", True, 2, 256, 240),
    ("merge_unmerged", True, 3, 256, 240),
    ("merge_unmerged", False, 2, 256, 240),
    ("gap", True, 2, 256, 240),
]


@pytest.mark.parametrize("name,lean,n,rows,nvalid", PE_SPLIT_CASES)
def test_split_pe_step_matches_unsplit(name, lean, n, rows, nvalid, tmp_path):
    cfg = _cfg(CONFIGS[name], lean, tmp_path=tmp_path)
    batch, padded = _split_batch(len(name) + n, rows, nvalid, n)
    aux = t_device.make_aux(cfg, nvalid)
    want = t_device.build_pe_step(cfg, "cpu")(*batch, *aux)
    split = t_mesh.build_sharded_step(t_device.build_pe_step, cfg,
                                      [torch.device("cpu")] * n)
    assert len(split.steps) == n and len({id(s) for s in split.steps}) == 1
    got = split(*batch, *aux)
    lists = PER_ROW_LISTS if cfg.correction_enabled else set()
    deltas = PER_ROW_DELTAS if cfg.correction_enabled else set()
    assert set(want) - set(got) == lists
    assert set(got) - set(want) == deltas
    _compare({k: v for k, v in got.items() if k not in deltas},
             {k: v for k, v in want.items() if k not in lists})
    assert got["pre1"]["qual_hist"].shape == (128,)
    assert got["rlen1"].shape == (padded,)
    if cfg.correction_enabled:
        assert got["c1k_pos"].dtype == np.int16
        assert got["c1k_pos"].shape == (12, padded)
        assert got["c1k_u8"].shape == (24, padded)
        for side in ("c1", "c2"):
            assert _deltas_of_rows(got, side) == \
                _deltas_of_sparse_list(want, side)
        assert int(want["c1_count"]) + int(want["c2_count"]) > 0


@pytest.mark.parametrize("name,lean", [("bench", True), ("cfg8", False)])
def test_split_step_deltas_match_jax_sharded_step(name, lean, tmp_path):
    """c1k_*/c2k_* of the joined split step against fastp_tpu's step built
    for a mesh (mega="sharded"), and every key both have."""
    cfg = _cfg(CONFIGS[name], lean, tmp_path=tmp_path)
    batch = _synth_batch(len(name))
    step_j = j_device.build_pe_step(cfg, mega="sharded")
    out = step_j(*batch, *j_device.make_aux(cfg, 240))
    want = j_device.unpack_from_host(jax.device_get(out), step_j.layout)
    got = t_mesh.build_sharded_step(
        t_device.build_pe_step, cfg, [torch.device("cpu")] * 2)(
            *batch, *t_device.make_aux(cfg, 240))
    assert PER_ROW_DELTAS <= set(want)
    _compare(got, want)
    assert (want["c1k_cnt"] > 0).any() and (want["c2k_cnt"] > 0).any()


@pytest.mark.parametrize("name,lean,n,rows", [
    ("cfg1", True, 2, 256), ("cfg1", False, 3, 256), ("bench", True, 3, 250),
    ("failed_out", False, 2, 256), ("bench", True, 2, 2048)])
def test_split_se_step_matches_unsplit(name, lean, n, rows, tmp_path):
    cfg = _cfg(SE_CONFIGS[name], lean, paired=False, tmp_path=tmp_path)
    nvalid = rows - 16
    batch, padded = _split_batch(len(name) + 100 + n, rows, nvalid, n,
                                 paired=False)
    aux = t_device.make_aux(cfg, nvalid)
    want = t_device.build_se_step(cfg, "cpu")(*batch, *aux)
    got = t_mesh.build_sharded_step(t_device.build_se_step, cfg,
                                    [torch.device("cpu")] * n)(*batch, *aux)
    _compare(got, want)
    assert got["rlen"].shape == (padded,)


def test_split_step_with_aux_masks(tmp_path):
    """UMI pre-trims, index drops and dedup verdicts are batch-major
    arguments: each shard gets its rows of them."""
    cfg = dataclasses.replace(_cfg(CONFIGS["bench"], True, tmp_path=tmp_path),
                              has_pretrim=True, has_index_drop=True,
                              has_dedup=True)
    batch = _synth_batch(5)
    rng = np.random.default_rng(5)
    aux = t_device.make_aux(cfg, 240, rng.integers(0, 6, 256),
                            rng.integers(0, 6, 256), rng.random(256) < 0.1,
                            rng.random(256) < 0.1)
    want = t_device.build_pe_step(cfg, "cpu")(*batch, *aux)
    got = t_mesh.build_sharded_step(t_device.build_pe_step, cfg,
                                    [torch.device("cpu")] * 2)(*batch, *aux)
    _compare({k: v for k, v in got.items() if k not in PER_ROW_DELTAS},
             {k: v for k, v in want.items() if k not in PER_ROW_LISTS})


def test_join_tells_leaves_apart_by_key_and_refuses_unknown_shapes():
    outs = [{"rlen": np.arange(4), "isize_hist": np.ones(4, np.int64),
             "pre": {"reads": np.int64(3)}, "c1k_pos": np.zeros((2, 4))}
            for _ in range(2)]
    res = t_mesh.join_outputs(outs, 4)
    assert res["rlen"].shape == (8,) and res["c1k_pos"].shape == (2, 8)
    assert np.array_equal(res["isize_hist"], np.full(4, 2))
    assert int(res["pre"]["reads"]) == 6
    with pytest.raises(ValueError, match="new_hist"):
        t_mesh.join_outputs([{"new_hist": np.ones(7)}] * 2, 4)
    with pytest.raises(ValueError, match="c1_rows"):
        t_mesh.join_outputs([{"c1_rows": np.ones(4)}] * 2, 4)
    with pytest.raises(ValueError, match="equal shards"):
        t_mesh.ShardedStep([None] * 3, 3).run(
            np.zeros((8, 4)), np.zeros((8, 4)), np.zeros(8), np.int32(8))


# ---------------------------------------------------------------------------
# the CLI


@contextlib.contextmanager
def _in_dir(path, **env):
    old, saved = os.getcwd(), {k: os.environ.get(k) for k in env}
    os.chdir(path)
    os.environ.update(env)
    try:
        yield
    finally:
        os.chdir(old)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_port(cwd, args, **env):
    """cli.run in this process on the CPU, in directory cwd."""
    os.makedirs(cwd, exist_ok=True)
    with _in_dir(cwd, **env):
        return cli.run(["fastp_tpu_torch"] + args, device="cpu")


GOLDEN_CASES = {
    "cfg1_se_default": ["-i", R1, "-o", "out.fq"],
    "cfg2_pe_default": ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"],
    "cfg3_pe_correction": ["-i", R1, "-I", R2, "-o", "out1.fq", "-O",
                           "out2.fq", "--correction", "--cut_right"],
}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("golden", sorted(GOLDEN_CASES))
def test_golden_with_devices(golden, n, tmp_path):
    res = run_port(tmp_path, GOLDEN_CASES[golden] + ["--devices", str(n)])
    assert res["batches"] == 1
    assert_same_outputs(tmp_path, os.path.join(GOLDENS, golden))


CORPUS_CASES = {
    "cfg1": ["-o", "out.fq"],
    "cfg2": ["-o", "out1.fq", "-O", "out2.fq"],
    "cfg3": ["-o", "out1.fq", "-O", "out2.fq", "--correction", "--cut_right"],
    "cfg5": ["--merge", "--merged_out", "merged.fq", "--out1", "out1.fq",
             "--out2", "out2.fq", "--dedup", "--dup_calc_accuracy", "1",
             "--overrepresentation_analysis"],
    "cfg8": ["-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
             "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
             "--overlapped_out", "ov.fq", "-l", "100"],
}


def _make_corpus(d, pairs, seed, *extra):
    r1, r2 = str(d / "R1.fq"), str(d / "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", str(pairs), "--seed", str(seed), *extra,
                    "--out1", r1, "--out2", r2], check=True,
                   capture_output=True)
    return r1, r2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 700-pair corpus read in batches of 256, and a cache of the
    --devices 1 run of each case."""
    d = tmp_path_factory.mktemp("mesh")
    r1, r2 = _make_corpus(d, 700, 17)
    one = {}

    def args_of(name):
        inputs = ["-i", r1] + ([] if name == "cfg1" else ["-I", r2])
        return inputs + CORPUS_CASES[name] + ["--batch_size", "256"]

    def one_device(name):
        if name not in one:
            one[name] = d / ("one_" + name)
            res = run_port(one[name], args_of(name) + ["--devices", "1"])
            assert res["batches"] == 3
        return one[name]

    return args_of, one_device


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", sorted(CORPUS_CASES))
def test_devices_match_one_device(corpus, name, n, tmp_path):
    args_of, one_device = corpus
    want = one_device(name)
    res = run_port(tmp_path, args_of(name) + ["--devices", str(n)])
    assert res["batches"] == 3
    files = assert_same_outputs(tmp_path, want)
    assert all(os.path.getsize(tmp_path / f) > 0 for f in files)


def test_rows_over_k_take_the_host_recompute(corpus, tmp_path, monkeypatch):
    """With FASTP_TPU_CORR_K=1 every row with two corrections or more
    exceeds its slots and is recomputed on the host; the outputs stay those
    of one device."""
    args_of, one_device = corpus
    want = one_device("cfg3")
    real = t_pe_runner.PairEndProcessor._host_correct_all
    recomputed = []

    def counting(self, batch1, batch2, out, B, rows=None):
        recomputed.append(len(rows))
        assert out["c1k_pos"].shape[0] == 1
        return real(self, batch1, batch2, out, B, rows=rows)

    monkeypatch.setattr(t_pe_runner.PairEndProcessor, "_host_correct_all",
                        counting)
    res = run_port(tmp_path, args_of("cfg3") + ["--devices", "2"],
                   FASTP_TPU_CORR_K="1")
    assert sum(recomputed) > 0
    assert res["corr_overflow_batches"] == len(recomputed) > 0
    assert_same_outputs(tmp_path, want)


def test_dedup_and_index_filter_with_devices(tmp_path):
    """The aux arguments of a split step carry real masks: dedup verdicts
    and index-filter drops (tests/test_multidevice.py's slow case, at 600
    pairs)."""
    r1, r2 = _make_corpus(tmp_path, 600, 23, "--dup-rate", "0.2")
    for path in (r1, r2):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        for r in range(0, 600, 7):
            lines[4 * r] = lines[4 * r].replace(b"ATCACGTT", b"CCCCCCCC")
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))
    (tmp_path / "index1.txt").write_text("CCCCCCCC\n")
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", "--dedup",
            "--filter_by_index1", str(tmp_path / "index1.txt"),
            "--correction", "--cut_right", "--batch_size", "256"]
    run_port(tmp_path / "dev1", args + ["--devices", "1"])
    run_port(tmp_path / "dev3", args + ["--devices", "3"])
    assert_same_outputs(tmp_path / "dev3", tmp_path / "dev1")
    with open(tmp_path / "dev1" / "fastp.json") as f:
        rep = json.load(f)
    assert rep["summary"]["before_filtering"]["total_reads"] > \
        rep["summary"]["after_filtering"]["total_reads"]
    assert rep["duplication"]["rate"] > 0


def test_devices_match_fastp_tpu_devices(corpus, tmp_path):
    """`python -m fastp_tpu --devices 2` on two forced host devices, as
    tests/test_multidevice.py runs it, against the port's --devices 2."""
    args_of, _ = corpus
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    run_module("fastp_tpu", tmp_path / "jax", args_of("cfg3") + ["--devices", "2"],
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = run_module("fastp_tpu_torch", tmp_path / "port",
                     args_of("cfg3") + ["--devices", "2"])
    assert "2 shards of every batch: cpu, cpu" in res.stderr
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# the rule of make_mesh


def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("cards,request_,n,want", [
    (1, "cuda", 0, ["cuda"]),                       # one card: nothing changes
    (4, "cuda", 0, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (4, "cuda", 2, ["cuda:0", "cuda:1"]),
    (4, "cuda", 1, ["cuda"]),
    (4, "cuda:2", 0, ["cuda:2"]),                   # an index stays on its card
    (4, "cuda:2", 1, ["cuda:2"]),
    (1, "cuda:0,cuda:0", 0, ["cuda:0", "cuda:0"]),  # two shards of one card
    (1, "cuda:0,cuda:0,cuda:0", 2, ["cuda:0", "cuda:0"]),
    (0, "cpu", 0, ["cpu"]),
    (0, "cpu", 3, ["cpu", "cpu", "cpu"]),
    (4, "cpu", 0, ["cpu"]),                         # the CPU has no count
])
def test_make_mesh_rule(cards, request_, n, want, monkeypatch):
    _cards(monkeypatch, cards)
    monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", request_)
    got = t_mesh.make_mesh(n, cli.resolve_devices())
    assert got == [torch.device(w) for w in want]
    assert cli.resolve_device() == torch.device(request_.split(",")[0])


@pytest.mark.parametrize("cards,request_,n,error,words", [
    (2, "cuda", 3, RuntimeError, "torch sees 2 CUDA device"),
    (1, "cuda", 2, RuntimeError, "torch sees 1 CUDA device"),
    (4, "cuda:1", 2, ValueError, "names one card"),
    (1, "cuda:0,cuda:0", 3, ValueError, "names 2"),
    (0, "cpu", -1, ValueError, "0 or more"),
])
def test_make_mesh_refuses(cards, request_, n, error, words, monkeypatch):
    _cards(monkeypatch, cards)
    with pytest.raises(error, match=words):
        t_mesh.make_mesh(n, cli.resolve_devices(request_))


def test_a_list_of_devices_is_of_one_kind(monkeypatch):
    _cards(monkeypatch, 1)
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        cli.resolve_devices("cpu,cuda:0")
    with pytest.raises(RuntimeError, match="torch sees 1"):
        cli.resolve_devices("cuda:0,cuda:1")


def test_devices_above_the_cards_raise_before_anything_is_written(
        tmp_path, monkeypatch):
    _cards(monkeypatch, 2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--devices 5: torch sees 2"):
        cli.run(["fastp_tpu_torch", "-i", R1, "-I", R2, "-o", "o1.fq", "-O",
                 "o2.fq", "--devices", "5"], device="cuda")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("request_,assign,want", [
    ("cuda", "", ["cuda:0", "cuda:0"]),       # not `cuda`: no split per child
    ("cuda:1", "", ["cuda:1", "cuda:1"]),
    ("cuda", "1", ["cuda:0", "cuda:1"]),
    ("cuda:0,cuda:1", "", ["cuda:0,cuda:1"] * 2),
])
def test_local_processes_hand_on_an_indexed_device(request_, assign, want,
                                                   tmp_path, monkeypatch):
    _cards(monkeypatch, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FASTP_TPU_ASSIGN_CHIPS", assign)
    seen = []

    class Child:
        def __init__(self, cmd, env=None, stderr=None):
            seen.append(env["FASTP_TPU_TORCH_DEVICE"])

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", Child)
    res = cli.run(["fastp_tpu_torch", "-i", R1, "-I", R2,
                   "--local_processes", "2"], device=request_)
    assert res == {"rc": 0, "local_processes": 2}
    assert seen == want
