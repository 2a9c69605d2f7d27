"""Paired-end merging in the port: `python -m fastp_tpu_torch --merge` on
the CPU, and its merge op.

* the cfg5 golden (tests/golden/cfg5_merge, tests/test_parity.py's flags):
  merged.fq, out1.fq and out2.fq byte for byte, fastp.json after the
  command-line normalisation; also with FASTP_TPU_NO_NATIVE=1, where the
  per-row routing loop replaces fastp_tpu's native route_pe;
* differential runs against `python -m fastp_tpu` on the 2,000-pair
  tools/make_synth.py corpus: the merge_full case of
  tests/test_fallback_routing.py (--include_unmerged, correction, failed
  and unpaired outputs) and its merge_dedup case (unmerged pairs routed to
  out1/out2 and --failed_out), each with and without the native library
  in the port's environment;
* ops.merge.merge_pairs against fastp_tpu.ops.merge.merge_pairs on seeded
  rows with offsets below, at and above 0 and rows that did not overlap.
"""
import os

import numpy as np
import pytest
import torch

from fastp_tpu.ops import merge as j_merge
from fastp_tpu_torch.ops import merge as t_merge
from test_torch_cli import (GOLDENS, R1, R2, assert_same_outputs, make_corpus,
                            one_torch_thread, run_module)  # noqa: F401

CFG5 = ["--merge", "--merged_out", "merged.fq", "--out1", "out1.fq",
        "--out2", "out2.fq", "--dedup", "--dup_calc_accuracy", "1",
        "--overrepresentation_analysis"]
CASES = {
    "merge_full": ["--merge", "--merged_out", "m.fq", "--include_unmerged",
                   "--unpaired1", "u1.fq", "--unpaired2", "u2.fq",
                   "--failed_out", "f.fq", "-o", "o1.fq", "-O", "o2.fq",
                   "--correction", "--cut_right", "-l", "100"],
    "merge_dedup": ["--merge", "--merged_out", "m.fq", "--dedup",
                    "--failed_out", "f.fq", "-o", "o1.fq", "-O", "o2.fq"],
}


@pytest.mark.parametrize("no_native", [False, True], ids=["native", "no_native"])
def test_golden_cfg5(no_native, tmp_path):
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    run_module("fastp_tpu_torch", tmp_path, ["-i", R1, "-I", R2] + CFG5, **env)
    files = assert_same_outputs(tmp_path, os.path.join(GOLDENS, "cfg5_merge"))
    assert files == ["fastp.json", "merged.fq", "out1.fq", "out2.fq"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The 2,000-pair corpus, and fastp_tpu's run of each case."""
    d = tmp_path_factory.mktemp("merge")
    r1, r2 = make_corpus(d)
    runs = {}
    for name, flags in CASES.items():
        runs[name] = d / ("jax_" + name)
        runs[name].mkdir()
        run_module("fastp_tpu", runs[name], ["-i", r1, "-I", r2] + flags)
    return ["-i", r1, "-I", r2], runs


@pytest.mark.parametrize("name,no_native", [
    ("merge_full", False), ("merge_full", True), ("merge_dedup", False),
    ("merge_dedup", True)])
def test_matches_fastp_tpu(corpus, name, no_native, tmp_path):
    inputs, runs = corpus
    env = {"FASTP_TPU_NO_NATIVE": "1"} if no_native else {}
    res = run_module("fastp_tpu_torch", tmp_path, inputs + CASES[name], **env)
    files = assert_same_outputs(tmp_path, runs[name])
    assert "m.fq" in files and os.path.getsize(tmp_path / "m.fq") > 0
    assert "Read pairs merged:" in res.stderr


def _merge_rows(seed, B=96, L=64):
    """Windowed pairs with qualities and an overlap per row: offsets from
    -20 to 20 (0 among them), overlap lengths up to the shorter read, and
    every fourth row not overlapped."""
    rng = np.random.default_rng(seed)
    s1 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L))
    s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    q1 = rng.integers(35, 75, (B, L)).astype(np.uint8)
    q2 = rng.integers(35, 75, (B, L)).astype(np.uint8)
    len1 = rng.integers(20, L + 1, B).astype(np.int32)
    len2 = rng.integers(20, L + 1, B).astype(np.int32)
    offset = rng.integers(-20, 21, B).astype(np.int32)
    offset[::7] = 0
    olen = np.where(offset >= 0, np.minimum(len1 - offset, len2),
                    np.minimum(len1, len2 + offset))
    olen = np.maximum(olen, 0).astype(np.int32)
    overlapped = (np.arange(B) % 4 != 3) & (olen > 0)
    pos = np.arange(L)
    for x, ln in ((s1, len1), (s2, len2), (q1, len1), (q2, len2)):
        x[pos[None, :] >= ln[:, None]] = 0
    return s1, q1, len1, s2, q2, len2, overlapped, offset, olen


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_pairs_matches_jax(seed):
    rows = _merge_rows(seed)
    L = rows[0].shape[1]
    want = j_merge.merge_pairs(*rows, out_width=2 * L)
    got = t_merge.merge_pairs(*(torch.from_numpy(x) for x in rows),
                              out_width=2 * L)
    for name, g, w in zip(("m_seq", "m_qual", "m_len", "len1_m", "len2_m"),
                          got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64)), name
    offset, overlapped = rows[7], rows[6]
    m_len = np.asarray(want[2])
    # the rows cover every kind: offsets < 0, = 0 and > 0, and no overlap
    for sel in (offset < 0, offset == 0, offset > 0):
        assert (m_len[sel & overlapped] > 0).any()
    assert (m_len[~overlapped] == 0).all() and (~overlapped).any()
