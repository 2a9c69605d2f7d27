"""The port's SE and PE steps (fastp_tpu_torch.pipeline.device.build_se_step
and build_pe_step on the CPU) against fastp_tpu's, key by key.

fastp_tpu's step returns packed buffers; unpack_from_host turns them into
the dict its host loop reads.  The port returns that dict directly.  Both
must have the same key set and, after casting to int64, the same values
(exact: every output is an integer, a bool or a byte).  Every config runs
lean and not lean: the test sets cfg.lean itself, so the comparison does
not depend on whether this process loaded the native library.  The gap
config's batch carries rows with planted one-base insertions, which only
the gapped overlap analysis accepts; the FASTA configs read a two-adapter
FASTA written for the test.
"""
import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from fastp_tpu.pipeline import device as j_device
from fastp_tpu.pipeline.static_cfg import device_cfg_from_options
from fastp_tpu_torch.cli import prepare_options
from fastp_tpu_torch.pipeline import device as t_device
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_overlap import gap_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R1 = os.path.join(ROOT, "tests", "testdata", "R1.fq")
R2 = os.path.join(ROOT, "tests", "testdata", "R2.fq")
BENCH = ["--correction", "--cut_right",
         "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
         "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
CONFIGS = {
    "cfg3": ["--correction", "--cut_right"],
    "bench": BENCH,
    "bench_polyg": BENCH + ["--trim_poly_g"],
    "cut_front_tail_polyx": ["--cut_front", "--cut_tail", "--trim_poly_x",
                             "-f", "2", "-t", "1", "--low_complexity_filter"],
    "cfg8": ["--correction", "--cut_right", "--failed_out", "f.fq",
             "--unpaired1", "u1.fq", "--overlapped_out", "ov.fq", "-l", "100"],
    # cfg5's device-side flags (its dedup and overrepresentation analysis
    # are host stages the step test does not feed)
    "merge": ["--merge", "--merged_out", "m.fq"],
    "merge_unmerged": ["--merge", "--merged_out", "m.fq", "--include_unmerged",
                       "--correction", "--cut_right"],
    "gap": ["--allow_gap_overlap_trimming", "--correction", "--cut_right"],
    "fasta": ["--adapter_fasta", "{fasta}"],
}
SE_CONFIGS = {
    "cfg1": [],
    "bench": ["-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"],
    "failed_out": ["--failed_out", "f.fq", "--cut_front", "-f", "3",
                   "--trim_poly_x"],
    "fasta": ["--adapter_fasta", "{fasta}"],
}
# tools/make_synth.py's read-through adapters, as one FASTA
FASTA = (">r1\nAGATCGGAAGAGCACACGTCTGAACTCCAGTCA\n"
         ">r2\nAGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT\n")


def _cfg(flags, lean, paired=True, tmp_path=None):
    if "{fasta}" in flags:
        fasta = tmp_path / "adapters.fa"
        fasta.write_text(FASTA)
        flags = [str(fasta) if f == "{fasta}" else f for f in flags]
    mates = ["-I", R2, "-o", "o1.fq", "-O", "o2.fq"] if paired else ["-o", "o.fq"]
    opt = prepare_options(["fastp_tpu_torch", "-i", R1] + mates + flags)
    return dataclasses.replace(device_cfg_from_options(opt), lean=lean)


def _plant_gap_rows(batch, n=48):
    """Overwrite the first n pairs with gap_rows' pairs (quality 'F')."""
    s1, l1, s2, l2 = gap_rows(12, B=n, L=batch[0].shape[1])
    for (b, q, ln), (s, sl) in zip((batch[0:3], batch[3:6]),
                                   ((s1, l1), (s2, l2))):
        b[:n] = s
        q[:n] = np.where(s > 0, ord("F"), 0)
        ln[:n] = sl


def _synth_batch(seed, B=256, L=160, nvalid=240):
    """tools/make_synth.py pairs (PE151, adapters, polyG, Ns), padded to L,
    with some reads shortened and the rows past nvalid left as padding."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synth
    rng = np.random.default_rng(seed)
    args = SimpleNamespace(short_insert_rate=0.25, qual_bins="nova4",
                           n_rate=0.002, polyg_rate=0.08, dup_rate=0.05)
    r1, r2, q1, q2 = make_synth._gen_chunk(rng, B, 151, args)
    out = []
    for r, q in ((r1, q1), (r2, q2)):
        b = np.zeros((B, L), np.uint8)
        qq = np.zeros((B, L), np.uint8)
        b[:, :151], qq[:, :151] = r, q
        ln = np.where(rng.random(B) < 0.2, rng.integers(0, 152, B), 151)
        ln = ln.astype(np.int32)
        pos = np.arange(L)
        b[pos[None, :] >= ln[:, None]] = 0
        qq[pos[None, :] >= ln[:, None]] = 0
        b[nvalid:] = qq[nvalid:] = 0
        ln[nvalid:] = 0
        out += [b, qq, ln]
    return out


def _compare(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _compare(got[k], want[k], path + k + ".")
            continue
        g = np.asarray(got[k]).astype(np.int64)
        w = np.asarray(want[k]).astype(np.int64)
        assert g.shape == w.shape, (path + k, g.shape, w.shape)
        assert np.array_equal(g, w), (path + k, np.argwhere(g != w)[:5])


def _run_jax(build, cfg, batch):
    step_j = build(cfg)
    out = step_j(*batch, *j_device.make_aux(cfg, 240))
    return j_device.unpack_from_host(jax.device_get(out), step_j.layout)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_matches_jax(name, lean, tmp_path):
    cfg = _cfg(CONFIGS[name], lean, tmp_path=tmp_path)
    batch = _synth_batch(len(name))
    if name == "gap":
        _plant_gap_rows(batch)
    want = _run_jax(j_device.build_pe_step, cfg, batch)
    got = t_device.build_pe_step(cfg, "cpu")(*batch, *t_device.make_aux(cfg, 240))
    _compare(got, want)
    assert ("result1" in got) == (not lean)
    if cfg.correction_enabled:
        assert int(want["c1_count"]) + int(want["c2_count"]) > 0
    if cfg.overlapped_out:  # the diff_pct = 0 re-analysis accepts some pairs
        assert 0 < int(want["ov0_ok"].sum()) < int(want["ov_ok"].sum()
                                                   if not lean else 240)
    if cfg.merge_enabled:   # some pairs merge and pass
        assert want["m_emit"].any()
        if cfg.merge_include_unmerged:
            assert int(want["post_um1"]["reads"]) > 0
    if cfg.allow_gap_overlap and not lean:   # the planted insertions
        assert want["ov_hasgap"][:48].sum() > 24
    if cfg.fasta_adapters:   # the FASTA adapters trim some reads
        assert (want["rlen1"] < want["rlen1_pre_adapter"]).any()


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("name", sorted(SE_CONFIGS))
def test_se_step_matches_jax(name, lean, tmp_path):
    cfg = _cfg(SE_CONFIGS[name], lean, paired=False, tmp_path=tmp_path)
    batch = _synth_batch(len(name) + 100)[:3]
    want = _run_jax(j_device.build_se_step, cfg, batch)
    got = t_device.build_se_step(cfg, "cpu")(*batch, *t_device.make_aux(cfg, 240))
    _compare(got, want)
    assert ("result" in got) == (not lean)
    if cfg.adapter_enabled and cfg.has_seq1:
        assert want["ad_found"].any()
    if cfg.fasta_adapters:
        assert (want["rlen"] < want["rlen_post_adapter"]).any()
