"""The narrow packed transfers of the port, both ways.  Everything is
integers and bytes: no tolerance, every comparison is exact.

* upload: io/native.py's packers (pack_p3, pack_nib, pack_bq) run on seeded
  numpy reads -- clean, N-rich, more quality values than the dictionary
  holds, odd lengths, pad rows, an exception list filled to its last slot --
  and their outputs go to fastp_tpu.pipeline.device._unpack_* (JAX on the
  CPU) and to the port's decoders: both give back the reads, byte for byte;
  one exception more and the packer refuses the batch;
* fetch: _slim_outputs + pack_for_host + unpack_from_host against the step's
  own output tensors, key by key and type by type, for every step config of
  tests/test_torch_step.py at L=160 (byte-ranged fields travel as biased
  int8) and at L=256 (no int8 above 190), a shard's per-row deltas, and
  FASTP_TPU_NO_SLIM / FASTP_TPU_NO_PACK;
* the CLI writes the same bytes as `python -m fastp_tpu` with each of
  FASTP_TPU_NO_P3, _NO_NIB, _NO_INPUT_PACK, _NO_PACK and _NO_SLIM set, and
  when an N-rich batch in mid-run makes the packers fall back for the rest
  of the run.
"""
import numpy as np
import pytest
import torch

from fastp_tpu.pipeline import device as j_device
from fastp_tpu_torch.io import native as t_native
from fastp_tpu_torch.pipeline import device as t_device
from test_torch_cli import (BENCH, assert_same_outputs, one_torch_thread,
                            run_module)  # noqa: F401
from test_torch_mesh import _make_corpus, run_port
from test_torch_step import CONFIGS, SE_CONFIGS, _cfg, _synth_batch

needs_native = pytest.mark.skipif(t_native.get_lib() is None,
                                  reason="the native host library did not "
                                         "build on this host")

# ---------------------------------------------------------------------------
# upload: packers -> decoders

B, W = 64, 160
CAPS = {"p3": t_native.nib_exc_cap(B * W), "nib": t_native.nib_exc_cap(B * W),
        "bq": t_native.PACK_EXC_CAP}
KINDS = ["clean", "n_rich", "many_quals", "odd_lengths", "pad_rows",
         "full_list"]


def _reads(kind, scheme, seed):
    """(bases, quals, lengths): uint8[B, W] zero-padded, int32[B]."""
    rng = np.random.default_rng(seed)
    lengths = np.full(B, 151, np.int32)
    if kind == "odd_lengths":
        lengths = (rng.integers(0, 80, B) * 2 + 1).astype(np.int32)
    if kind == "pad_rows":
        lengths[-10:] = 0
    if kind == "full_list":
        lengths[:] = W
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, W))
    qvals = np.frombuffer(b"F:", np.uint8)
    probs = [0.9, 0.1]
    if kind == "many_quals":    # the rare values ride the exception list
        qvals = np.frombuffer(b"F:,#5I", np.uint8)
        probs = [0.5, 0.4, 0.04, 0.03, 0.02, 0.01]
    quals = rng.choice(qvals, (B, W), p=probs)
    if kind == "n_rich":
        n = rng.random((B, W)) < 0.05
        bases[n] = ord("N")
        quals[n] = ord("#")
        bases[rng.random((B, W)) < 0.005] = ord("n")   # not even bq's
    if kind == "full_list":     # a byte no scheme encodes, cap times
        flat = rng.choice(B * W, CAPS[scheme], replace=False)
        bases.reshape(-1)[flat] = ord("n")
    pad = np.arange(W)[None, :] >= lengths[:, None]
    bases[pad] = 0
    quals[pad] = 0
    return bases, quals, lengths


def _pack(scheme, bases, quals):
    """(packed arrays + exception list, dictionary or None, exceptions)."""
    if scheme == "bq":
        res = t_native.pack_bq(bases, quals)
        return (None, None, 0) if res is None else (res[:4], None, res[4])
    size = 2 if scheme == "p3" else 4
    qdict, qn = np.zeros(size, np.uint8), np.zeros(1, np.int32)
    fn = t_native.pack_p3 if scheme == "p3" else t_native.pack_nib
    res = fn(bases, quals, qdict, qn)
    return (None, None, 0) if res is None else (res[:-1], qdict, res[-1])


def _decode(mod, scheme, packed, qdict, lengths, conv):
    exc = [conv(a) for a in packed[-3:]]
    if scheme == "p3":
        return mod._unpack_p3(conv(packed[0]), conv(packed[1]), conv(qdict),
                              conv(lengths), *exc)
    if scheme == "nib":
        return mod._unpack_nib(conv(packed[0]), conv(qdict), conv(lengths),
                               *exc)
    return mod._unpack_bq(conv(packed[0]), *exc)


@needs_native
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scheme", ["p3", "nib", "bq"])
def test_decoders_match_jax_and_give_the_reads_back(scheme, kind):
    bases, quals, lengths = _reads(kind, scheme, len(kind) * 7 + len(scheme))
    packed, qdict, n_exc = _pack(scheme, bases, quals)
    assert packed is not None
    if kind == "full_list":
        assert n_exc == CAPS[scheme] == len(packed[-3])
    elif kind == "n_rich" or (kind == "many_quals" and scheme != "bq"):
        # bq holds every quality of the phred range: nothing is rare to it
        assert 0 < n_exc < CAPS[scheme]
    want = _decode(j_device, scheme, packed, qdict, lengths, np.asarray)
    got = _decode(t_device, scheme, packed, qdict, lengths, torch.from_numpy)
    for g, w, orig in zip(got, want, (bases, quals)):
        g = g.numpy()
        assert g.dtype == np.uint8 and g.shape == (B, W)
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, orig)


@needs_native
@pytest.mark.parametrize("scheme", ["p3", "nib", "bq"])
def test_one_exception_too_many_is_refused(scheme):
    bases, quals, _ = _reads("full_list", scheme, 5)
    spare = np.flatnonzero(bases.reshape(-1) != ord("n"))[0]
    bases.reshape(-1)[spare] = ord("n")
    assert _pack(scheme, bases, quals)[0] is None


def test_exception_indices_out_of_range_are_dropped():
    """The unused slots of an exception list hold B*W; nothing past the
    array is written and nothing inside it changes."""
    b = torch.full((4, 8), 65, dtype=torch.uint8)
    q = torch.full((4, 8), 70, dtype=torch.uint8)
    idx = torch.tensor([3, 32, 32, 31, 40, -1], dtype=torch.int32)
    val = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.uint8)
    nb, nq = t_device._scatter_exceptions(b, q, idx, val, val + 10)
    want = np.full(32, 65, np.uint8)
    want[3], want[31] = 1, 4
    assert np.array_equal(nb.numpy().reshape(-1), want)
    assert nq.numpy().reshape(-1)[[3, 31]].tolist() == [11, 14]
    assert (nq.numpy().reshape(-1) != 70).sum() == 2


def test_length_dtype():
    assert t_device.length_dtype(160) == j_device.length_dtype(160) == np.int16
    assert (t_device.length_dtype(32001) == j_device.length_dtype(32001)
            == np.int32)


# ---------------------------------------------------------------------------
# fetch: slim + pack + unpack against the step's own tensors


def _narrow_type(key, value, L, layout):
    """The numpy type unpack_from_host gives a leaf of the step."""
    if value.dtype in (torch.bool, torch.uint8):
        return {torch.bool: np.bool_, torch.uint8: np.uint8}[value.dtype]
    if (key in t_device.REDUCED_KEYS or key in t_device._LIST_KEYS
            or value.dim() != 1):
        # sums, the sparse lists (16 bits on the way, int32 on arrival) and
        # the [K, B] delta matrices
        return {torch.int16: np.int16}.get(value.dtype, np.int32)
    return np.int16 if L <= 32000 else np.int32


def _check_roundtrip(step, args, L, expect_i8):
    out = step.run(*args)
    want = {k: ({dk: dv.clone() for dk, dv in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in out.items()}
    pending = step.start_fetch(out)
    layout = pending.layout
    got = pending.wait()
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert set(got[k]) == set(w), k
            for dk, dv in w.items():
                assert got[k][dk].dtype == np.int32, (k, dk)
                assert got[k][dk].shape == tuple(dv.shape), (k, dk)
                assert np.array_equal(got[k][dk], dv.numpy()), (k, dk)
            continue
        g = np.asarray(got[k])
        assert g.dtype == _narrow_type(k, w, L, layout), (k, g.dtype)
        assert g.shape == tuple(w.shape), k
        assert np.array_equal(g.astype(np.int64),
                              w.numpy().astype(np.int64)), k
    assert bool(layout["i8_keys"]) == expect_i8
    if expect_i8:
        assert set(layout["i8_keys"]) <= (t_device._I8_KEYS
                                          | set(step.io.extra_i8))
        assert "rlen" in layout["i8_keys"] or "rlen1" in layout["i8_keys"]
    assert len(layout["bool_keys"]) >= 1
    return got, layout


@pytest.mark.parametrize("L", [160, 256])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pe_outputs_survive_the_packed_fetch(name, lean, L, tmp_path):
    cfg = _cfg(CONFIGS[name], lean, tmp_path=tmp_path)
    batch = _synth_batch(len(name) + L, L=L)
    step = t_device.build_pe_step(cfg, "cpu")
    got, layout = _check_roundtrip(
        step, (*batch, *t_device.make_aux(cfg, 240)), L, expect_i8=L <= 190)
    if cfg.correction_enabled:
        names = dict((k, dt) for k, dt, *_ in layout["mega"])
        assert names["_corr_rows"] == "uint16"
        assert names["_corr_pos"] == ("uint8" if L <= 255 else "uint16")
        assert got["c1_rows"].dtype == got["c1_pos"].dtype == np.int32


@pytest.mark.parametrize("L", [160, 256])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("name", sorted(SE_CONFIGS))
def test_se_outputs_survive_the_packed_fetch(name, lean, L, tmp_path):
    cfg = _cfg(SE_CONFIGS[name], lean, paired=False, tmp_path=tmp_path)
    batch = _synth_batch(len(name) + L + 100, L=L)[:3]
    step = t_device.build_se_step(cfg, "cpu")
    _check_roundtrip(step, (*batch, *t_device.make_aux(cfg, 240)), L,
                     expect_i8=L <= 190)


@pytest.mark.parametrize("L", [160, 256])
def test_a_shards_row_deltas_ride_the_same_buffer(L, tmp_path):
    cfg = _cfg(CONFIGS["bench"], True, tmp_path=tmp_path)
    batch = _synth_batch(3, L=L)
    step = t_device.build_pe_step(cfg, "cpu", rowwise=True)
    got, layout = _check_roundtrip(
        step, (*batch, *t_device.make_aux(cfg, 240)), L, expect_i8=L <= 190)
    assert got["c1k_pos"].dtype == np.int16 and got["c1k_pos"].shape[1] == 256
    assert got["c1k_u8"].dtype == np.uint8
    assert "c1k_cnt" in layout["i16_keys"]
    assert int(got["c1k_cnt"].sum()) > 0


@pytest.mark.parametrize("knob", ["FASTP_TPU_NO_SLIM", "FASTP_TPU_NO_PACK"])
def test_fetch_knobs_change_types_and_bytes_only(knob, tmp_path, monkeypatch):
    cfg = _cfg(CONFIGS["cfg8"], False, tmp_path=tmp_path)
    batch = _synth_batch(9)
    args = (*batch, *t_device.make_aux(cfg, 240))
    step = t_device.build_pe_step(cfg, "cpu")
    want = step(*args)
    moved = t_device.fetch_stats["bytes"]
    step(*args)
    moved = t_device.fetch_stats["bytes"] - moved
    monkeypatch.setenv(knob, "1")
    before = dict(t_device.fetch_stats)
    pending = step.start_fetch(step.run(*args))
    got = pending.wait()
    slim_off = knob == "FASTP_TPU_NO_SLIM"
    assert pending.layout["packed"] == slim_off
    # unpacked leaves are still narrowed to int16, but never biased to int8
    assert not pending.layout.get("i8_keys")
    assert got["rlen1"].dtype == (np.int32 if slim_off else np.int16)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            for dk in w:
                assert np.array_equal(got[k][dk], w[dk]), (k, dk)
        else:
            assert np.array_equal(np.asarray(got[k]).astype(np.int64),
                                  np.asarray(w).astype(np.int64)), k
    # wider types, more bytes; unpacked, a transfer per leaf
    assert t_device.fetch_stats["bytes"] - before["bytes"] > moved
    fetches = t_device.fetch_stats["fetches"] - before["fetches"]
    assert (fetches == 1) == slim_off


def test_sums_widen_when_a_batch_could_pass_int32():
    """pack_for_host sends a batch's sums as int32 only while rows x width
    bounds them below 2**31."""
    out = {"rlen": torch.zeros(4, dtype=torch.int32),
           "pre": {"reads": torch.tensor(2 ** 40)},
           "polyx_reads": torch.full((4,), 2 ** 33)}
    for rows, width, want in ((4, 160, np.int32), (70000, 160, np.int64)):
        layout = {}
        packed = t_device.pack_for_host(
            {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in out.items()}, rows, layout, width)
        got = t_device.unpack_from_host(
            {"_blob": packed["_blob"].numpy()}, layout)
        assert got["pre"]["reads"].dtype == got["polyx_reads"].dtype == want
        if want == np.int64:
            assert int(got["pre"]["reads"]) == 2 ** 40
            assert got["polyx_reads"].tolist() == [2 ** 33] * 4


# ---------------------------------------------------------------------------
# the CLI with the knobs

OUT2 = ["-o", "out1.fq", "-O", "out2.fq"]
# knob -> the scheme the 2-level corpus then travels in
KNOBS = {None: "p3", "FASTP_TPU_NO_P3": "nib", "FASTP_TPU_NO_NIB": "bq",
         "FASTP_TPU_NO_INPUT_PACK": "plain", "FASTP_TPU_NO_PACK": "p3",
         "FASTP_TPU_NO_SLIM": "p3"}


def _two_level_quals(path):
    """Rewrite a FASTQ file's quality lines to two values (a high one, and
    a low one where the line had its lowest), the data p3 is made for."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for k in range(3, len(lines), 4):
        q = np.frombuffer(lines[k], np.uint8)
        lines[k] = np.where(q <= q.min(), ord(","), ord("F")) \
            .astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


def _n_rich_middle(path, first, last):
    """Turn every third base of the records first..last-1 into N."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for rec in range(first, last):
        s = bytearray(lines[4 * rec + 1])
        s[::3] = b"N" * len(s[::3])
        lines[4 * rec + 1] = bytes(s)
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A 600-pair corpus with two quality levels, a copy whose third batch
    of 128 is N-rich, and fastp_tpu's run of both (PE) and of read 1 (SE)."""
    d = tmp_path_factory.mktemp("pack")
    (d / "clean").mkdir()
    (d / "nrich").mkdir()
    clean = _make_corpus(d / "clean", 600, 61)
    nrich = _make_corpus(d / "nrich", 600, 61)
    for p in clean + nrich:
        _two_level_quals(p)
    for p in nrich:
        _n_rich_middle(p, 256, 384)
    args = {"clean": ["-i", clean[0], "-I", clean[1]] + OUT2 + BENCH,
            "nrich": ["-i", nrich[0], "-I", nrich[1]] + OUT2 + BENCH,
            "se": ["-i", nrich[0], "-o", "out.fq", "-a", BENCH[3]]}
    args = {k: v + ["--batch_size", "128"] for k, v in args.items()}
    jax_dirs = {}
    for name in args:
        jax_dirs[name] = d / ("jax_" + name)
        jax_dirs[name].mkdir()
        run_module("fastp_tpu", jax_dirs[name], args[name])
    return args, jax_dirs


@needs_native
@pytest.mark.parametrize("knob", sorted(KNOBS, key=str))
def test_cli_bytes_with_each_knob(corpora, knob, tmp_path):
    args, jax_dirs = corpora
    res = run_port(tmp_path, args["clean"], **({knob: "1"} if knob else {}))
    assert res["input_kinds"] == {KNOBS[knob]: 5}
    assert_same_outputs(tmp_path, jax_dirs["clean"])


@needs_native
@pytest.mark.parametrize("name", ["nrich", "se"])
def test_an_n_rich_batch_turns_packing_down_for_the_run(corpora, name,
                                                        tmp_path):
    """Batches 1 and 2 travel at 3 bits; batch 3 (every third base N)
    overflows the exception lists of p3 and nib and travels at one byte;
    the clean batches after it stay there: the schemes that a run has
    fallen out of stay off."""
    args, jax_dirs = corpora
    res = run_port(tmp_path, args[name])
    assert res["input_kinds"] == {"p3": 2, "bq": 3}
    assert_same_outputs(tmp_path, jax_dirs[name])


def test_without_the_native_library_inputs_travel_plain(corpora, tmp_path):
    args, jax_dirs = corpora
    res = run_port(tmp_path, args["clean"], FASTP_TPU_NO_NATIVE="1")
    assert res["input_kinds"] == {"plain": 5}
    assert_same_outputs(tmp_path, jax_dirs["clean"])


def test_a_split_takes_plain_inputs(corpora, tmp_path):
    args, jax_dirs = corpora
    res = run_port(tmp_path, args["clean"] + ["--devices", "2"])
    assert res["input_kinds"] == {"plain": 5}
    assert_same_outputs(tmp_path, jax_dirs["clean"])


def test_upload_bytes_are_counted(corpora, tmp_path):
    """fetch_stats counts the uploads too: packed inputs move fewer bytes
    to the device than plain ones."""
    args, _ = corpora
    moved = {}
    for knob in (None, "FASTP_TPU_NO_INPUT_PACK"):
        before = dict(t_device.fetch_stats)
        run_port(tmp_path / str(knob), args["clean"],
                 **({knob: "1"} if knob else {}))
        moved[knob] = (t_device.fetch_stats["upload_bytes"]
                       - before["upload_bytes"])
        assert t_device.fetch_stats["uploads"] > before["uploads"]
    if t_native.get_lib() is not None:
        assert 0 < moved[None] < moved["FASTP_TPU_NO_INPUT_PACK"] / 2
