"""The port's own host modules against fastp_tpu's, on the CPU.

fastp_tpu_torch imports nothing of fastp_tpu: it keeps a copy of each host
module it needs under the same relative name.  These tests hold the copies
to the originals from the same inputs:

* the command-line parser: the same option strings, destinations, types
  and defaults; `options_from_args` and `device_cfg_from_options` give
  equal results for the argument lists of the goldens cfg1 to cfg8 and for
  a few more that reach the UMI, index-filter, split and FASTA branches;
* the constants of config.py and the table of known adapters;
* the native library: each package builds its own (different files), and
  the two tokenize and serialize the golden inputs alike;
* the evaluator's pre-pass on the golden inputs;
* the copies whose code is still the original's are listed, so that a
  change to one of them is a decision and not an accident.
"""
import ast
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

import fastp_tpu.cli as j_cli
import fastp_tpu.config as j_config
import fastp_tpu.evaluator as j_evaluator
import fastp_tpu.io.fastq as j_fastq
import fastp_tpu.io.native as j_native
import fastp_tpu.knownadapters as j_known
import fastp_tpu.pipeline.static_cfg as j_static
import fastp_tpu.utils.readname as j_readname
import fastp_tpu_torch.cli as t_cli
import fastp_tpu_torch.config as t_config
import fastp_tpu_torch.evaluator as t_evaluator
import fastp_tpu_torch.io.fastq as t_fastq
import fastp_tpu_torch.io.native as t_native
import fastp_tpu_torch.knownadapters as t_known
import fastp_tpu_torch.pipeline.static_cfg as t_static
import fastp_tpu_torch.utils.readname as t_readname

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R1 = os.path.join(ROOT, "tests", "testdata", "R1.fq")
R2 = os.path.join(ROOT, "tests", "testdata", "R2.fq")
PE = ["-i", R1, "-I", R2]
# the goldens' argument lists (tests/test_parity.py), then a few that reach
# the other branches of options_from_args
ARGS = {
    "cfg1": ["-i", R1, "-o", "out.fq"],
    "cfg2": PE + ["-o", "out1.fq", "-O", "out2.fq"],
    "cfg3": PE + ["-o", "out1.fq", "-O", "out2.fq", "--correction",
                  "--cut_right"],
    "cfg4": PE + ["-o", "out1.fq", "-O", "out2.fq", "--trim_poly_g",
                  "--trim_poly_x", "--umi", "--umi_loc", "read1", "--umi_len",
                  "4", "--low_complexity_filter"],
    "cfg5": PE + ["--merge", "--merged_out", "merged.fq", "--out1", "out1.fq",
                  "--out2", "out2.fq", "--dedup", "--dup_calc_accuracy", "1",
                  "--overrepresentation_analysis"],
    "cfg6": PE + ["-o", "out1.fq", "-O", "out2.fq", "--failed_out",
                  "failed.fq", "--unpaired1", "up1.fq", "--unpaired2",
                  "up2.fq", "-l", "100"],
    "cfg7": PE + ["-o", "out1.fq", "-O", "out2.fq", "-s", "3", "-w", "1"],
    "cfg8": PE + ["-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
                  "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
                  "--overlapped_out", "ov.fq", "-l", "100"],
    "bench": PE + ["-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right",
                   "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
                   "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"],
    "index_umi": PE + ["--umi", "--umi_loc", "per_index", "--umi_prefix", "U",
                       "--filter_by_index_threshold", "1", "-f", "3", "-T", "2",
                       "-5", "-3", "--cut_front_window_size", "5",
                       "--cut_tail_mean_quality", "25", "-e", "20",
                       "--length_limit", "140", "-Y", "40", "-y"],
    "lines_gap": ["-i", R1, "-S", "400", "-d", "2", "-z", "6",
                  "--allow_gap_overlap_trimming", "--interleaved_in",
                  "--stdout", "-D", "--batch_size", "512",
                  "--overlap_len_require", "20", "--overlap_diff_limit", "3",
                  "--overlap_diff_percent_limit", "10", "-6", "-V"],
}


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.nargs, a.const,
             type(a).__name__) for a in parser._actions]


def test_parsers_have_the_same_options_and_defaults():
    ours, theirs = _actions(t_cli.build_parser()), _actions(j_cli.build_parser())
    assert len(ours) > 80
    assert ours == theirs


def test_parsers_differ_only_in_their_name():
    assert t_cli.build_parser().prog == "fastp_tpu_torch"
    assert j_cli.build_parser().prog == "fastp_tpu"


def _options(cli, name):
    argv = ["prog"] + ARGS[name]
    args = cli.build_parser().parse_args(["-h2" if a == "-h" else a
                                          for a in argv[1:]])
    return cli.options_from_args(args, argv)


@pytest.mark.parametrize("name", sorted(ARGS))
def test_options_from_args_are_equal(name):
    ours, theirs = _options(t_cli, name), _options(j_cli, name)
    assert type(ours) is t_config.Options and type(theirs) is j_config.Options
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_options_from_args_reads_an_adapter_fasta(tmp_path):
    fasta = tmp_path / "adapters.fa"
    fasta.write_text(">a\nAGATCGGAAGAGCACACGTCTGAACTCCAGTCA\n>b\nCTGTCTCTTATACACATCT\n")
    got = []
    for cli in (t_cli, j_cli):
        argv = ["prog", "-i", R1, "--adapter_fasta", str(fasta)]
        got.append(dataclasses.asdict(cli.options_from_args(
            cli.build_parser().parse_args(argv[1:]), argv)))
    assert got[0] == got[1]
    assert len(got[0]["adapter"]["seqsInFasta"]) == 2


@pytest.mark.parametrize("name", sorted(ARGS))
def test_device_cfg_fields_are_equal(name, monkeypatch):
    # `lean` depends on whether each package's native library loaded; take
    # that out of the comparison by asking both for the Python path
    monkeypatch.setattr(t_native, "get_lib", lambda: None)
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    ours = t_static.device_cfg_from_options(_options(t_cli, name))
    theirs = j_static.device_cfg_from_options(_options(j_cli, name))
    assert [f.name for f in dataclasses.fields(ours)] \
        == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_validate_refuses_the_same_options(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    codes = []
    for cli in (t_cli, j_cli):
        opt = _options(cli, "cfg2")
        opt.in1 = ""
        with pytest.raises(SystemExit) as exc:
            opt.validate()
        codes.append(exc.value.code)
    assert codes[0] == codes[1] != 0


def _constants(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, (int, float, str, tuple, list, dict))}


@pytest.mark.parametrize("name", sorted(_constants(j_config)))
def test_config_constants_are_equal(name):
    assert _constants(t_config)[name] == _constants(j_config)[name]


def test_config_has_the_filter_and_failure_constants():
    names = set(_constants(t_config))
    assert names == set(_constants(j_config))
    assert {"PASS_FILTER", "FAIL_LENGTH", "FAILED_TYPES", "FILTER_RESULT_TYPES",
            "FASTP_TPU_VER", "UMI_LOC_PER_READ"} <= names


def test_known_adapters_are_equal():
    ours, theirs = t_known.get_known_adapters(), j_known.get_known_adapters()
    assert len(ours) > 100
    assert ours == theirs
    assert list(ours) == list(theirs)   # the scan order is part of the result


@pytest.mark.parametrize("name", [
    b"@A00123:45:HXXXX:1:1101:1000:2000 1:N:0:ACGT+TGCA",
    b"@V300012345L1C001R0010000001/1", b"@r 2:N:0:GATTACA", b"@x"])
def test_readname_helpers_are_equal(name):
    for fn in ("first_index", "last_index", "fix_mgi"):
        assert getattr(t_readname, fn)(name) == getattr(j_readname, fn)(name), fn


@pytest.fixture(scope="module")
def native_libs():
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither package can build its native library")
    ours, theirs = t_native.get_lib(), j_native.get_lib()
    if ours is None or theirs is None:
        pytest.skip("a native library did not build or load here")
    return ours, theirs


def test_native_libraries_are_two_files(native_libs):
    ours, theirs = native_libs
    assert os.path.realpath(ours._name) != os.path.realpath(theirs._name)
    assert os.path.basename(ours._name).startswith("libfastq_native_torch-")
    assert os.sep + "fastp_tpu_torch" + os.sep in os.path.realpath(ours._name) \
        or "fastp_tpu_torch_native" in ours._name
    assert os.sep + "fastp_tpu" + os.sep + "native" not in os.path.realpath(ours._name)


@pytest.mark.parametrize("compiles", [True, False])
def test_native_build_is_atomic(compiles, tmp_path, monkeypatch):
    """The compiler writes a temporary file that is renamed to the library's
    path only when it succeeded: the path never holds a partial file, and a
    failed build leaves nothing behind."""
    target = tmp_path / "libx.so"
    seen = []

    def fake_gxx(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        seen.append((out, target.exists()))
        with open(out, "wb") as fh:
            fh.write(b"half" if not compiles else b"whole")
        return subprocess.CompletedProcess(cmd, 0 if compiles else 1, b"", b"no")

    monkeypatch.setattr(t_native.subprocess, "run", fake_gxx)
    assert t_native._build(str(target)) is compiles
    assert all(out != str(target) and os.path.dirname(out) == str(tmp_path)
               and not existed for out, existed in seen)
    assert len(seen) == (1 if compiles else 2)   # with and without libdeflate
    assert os.listdir(tmp_path) == (["libx.so"] if compiles else [])
    if compiles:
        assert target.read_bytes() == b"whole"


@pytest.mark.parametrize("path", [R1, R2])
def test_native_tokenize_is_equal(native_libs, path):
    buf = np.frombuffer(open(path, "rb").read(), np.uint8)
    ours = t_native.tokenize(buf, True, 64, 160, False)
    theirs = j_native.tokenize(buf, True, 64, 160, False)
    n = ours[0]
    assert n == theirs[0] > 0
    for a, b in zip(ours, theirs):
        if isinstance(a, np.ndarray):
            if a.ndim == 2:   # rows are defined up to each read's length
                lens = ours[3][:n]
                keep = np.arange(a.shape[1])[None, :] < lens[:, None]
                assert np.array_equal(a[:n][keep], b[:n][keep])
            else:
                assert np.array_equal(a[:n], b[:n])
        else:
            assert a == b


@pytest.mark.parametrize("path", [R1, R2])
def test_batch_readers_and_serializer_are_equal(native_libs, path):
    """Each package's reader on the same file, then each package's native
    serializer on the reader's batch with a trimmed window: the same arrays
    and the same FASTQ bytes."""
    blobs = []
    batches = []
    for fastq, native in ((t_fastq, t_native), (j_fastq, j_native)):
        reader = fastq.open_batch_reader(path, False)
        batch = reader.read_batch(8192, 160)
        reader.close()
        n = batch.n
        tf = np.full(n, 2, np.int32)
        rlen = np.maximum(batch.lengths.astype(np.int32) - 5, 0)
        emit = np.arange(n) % 3 != 0
        nbuf, noff, nlen = batch.name_buffers()
        sbuf, soff, slen = batch.strand_buffers()
        blobs.append(bytes(native.serialize(
            nbuf, noff, nlen, sbuf, soff, slen, batch.bases, batch.quals, tf,
            rlen, emit, batch.width)))
        batches.append(batch)
    ours, theirs = batches
    assert ours.n == theirs.n > 0 and ours.width == theirs.width
    assert np.array_equal(ours.lengths, theirs.lengths)
    keep = np.arange(ours.width)[None, :] < ours.lengths[:, None]
    assert np.array_equal(ours.bases[keep], theirs.bases[keep])
    assert np.array_equal(ours.quals[keep], theirs.quals[keep])
    assert [ours.name(i) for i in range(ours.n)] \
        == [theirs.name(i) for i in range(theirs.n)]
    assert blobs[0] == blobs[1] and blobs[0].count(b"\n") == 4 * int(
        (np.arange(ours.n) % 3 != 0).sum())


@pytest.mark.parametrize("no_native", [False, True])
def test_evaluator_prepass_is_equal(no_native, monkeypatch):
    if no_native:
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
    got = []
    for cli, evaluator in ((t_cli, t_evaluator), (j_cli, j_evaluator)):
        opt = _options(cli, "cfg5")
        eva = evaluator.Evaluator(opt)
        eva.evaluate_seq_len()
        eva.evaluate_overrep_seqs()
        got.append((opt.seqLen1, opt.seqLen2, eva.eval_adapter_and_read_num(False),
                    eva.is_two_color_system(), opt.overRepSeqs1,
                    opt.overRepSeqs2))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][1] > 0


# copies whose code is the original's (comments aside: the port's say
# nothing of the TPU host); a later change to one of them takes it off this
# list on purpose
SAME_CODE = [
    "config.py", "duplicate.py", "evaluator.py", "knownadapters.py", "umi.py",
    "io/fasta.py", "io/fastq.py", "utils/log.py", "utils/readname.py",
    "report/filter_model.py", "report/stats_model.py", "report/jsonreport.py",
    "report/htmlreport.py", "pipeline/static_cfg.py", "pipeline/hostview.py",
    "pipeline/pe_route.py", "native/fastq_native.cpp",
    "native/route_native.cpp"]


def _code(path):
    """A source file without its comments: the syntax tree of a Python
    file less its docstrings, or the C++ lines with `//` remarks cut off."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".py"):
        tree = ast.parse(text)
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(body, list):
                node.body = [n for n in body if not (
                    isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)
                    and isinstance(n.value.value, str))]
        return ast.dump(tree)
    lines = [re.sub(r"\s*//.*", "", ln).rstrip() for ln in text.splitlines()]
    return [ln for ln in lines if ln]


@pytest.mark.parametrize("rel", SAME_CODE)
def test_copy_has_the_originals_code(rel):
    ours = _code(os.path.join(ROOT, "fastp_tpu_torch", rel))
    assert ours == _code(os.path.join(ROOT, "fastp_tpu", rel))
    assert len(ours) > 10


# -- the copies this file holds to the originals since the server, the
# -- shards of --local_processes, the batch runner and the self-test came

import contextlib  # noqa: E402
import gzip  # noqa: E402
import io  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import fastp_tpu.batch as j_batch  # noqa: E402
import fastp_tpu.parallel.multihost as j_multihost  # noqa: E402
import fastp_tpu.selftest as j_selftest  # noqa: E402
import fastp_tpu.server as j_server  # noqa: E402
import fastp_tpu_torch.batch as t_batch  # noqa: E402
import fastp_tpu_torch.parallel.multihost as t_multihost  # noqa: E402
import fastp_tpu_torch.selftest as t_selftest  # noqa: E402
import fastp_tpu_torch.server as t_server  # noqa: E402


@pytest.fixture(scope="module")
def shard_corpus(tmp_path_factory):
    """700 synthetic pairs (a fifth duplicates) as two files, as gzip and
    as one interleaved file."""
    d = tmp_path_factory.mktemp("shards")
    r1, r2 = str(d / "R1.fq"), str(d / "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "700", "--dup-rate", "0.2", "--seed", "9",
                    "--out1", r1, "--out2", r2], check=True, capture_output=True)
    for path in (r1, r2):
        with open(path, "rb") as fin, gzip.open(path + ".gz", "wb") as out:
            out.write(fin.read())
    inter = str(d / "inter.fq")
    with open(r1, "rb") as f1, open(r2, "rb") as f2, open(inter, "wb") as out:
        for _ in range(700):
            out.writelines([f1.readline() for _ in range(4)]
                           + [f2.readline() for _ in range(4)])
    return {"plain": ["-i", r1, "-I", r2], "se": ["-i", r1],
            "gz": ["-i", r1 + ".gz", "-I", r2 + ".gz"],
            "interleaved": ["-i", inter, "--interleaved_in"]}


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_shard_ranges_are_equal(shard_corpus, n):
    r1, r2 = shard_corpus["plain"][1], shard_corpus["plain"][3]
    ours = t_multihost.shard_ranges(r1, r2, n)
    assert ours == j_multihost.shard_ranges(r1, r2, n)
    assert t_multihost.shard_ranges(r1, None, n) \
        == j_multihost.shard_ranges(r1, None, n)
    # the ranges tile the file, and both files are cut at the same records
    assert ours[0][0][0] == 0 and ours[0][-1][1] == os.path.getsize(r1)
    assert all(a[1] == b[0] for a, b in zip(ours[0], ours[0][1:]))
    cuts = lambda path, ranges: t_multihost._newlines_before(
        path, [lo for lo, _ in ranges])
    assert cuts(r1, ours[0]) == cuts(r2, ours[1])
    assert all(c % 4 == 0 for c in cuts(r1, ours[0]))


def _sharded_options(cli, multihost, args, k, n, monkeypatch):
    monkeypatch.setenv("FASTP_TPU_SHARD_INDEX", str(k))
    monkeypatch.setenv("FASTP_TPU_SHARD_COUNT", str(n))
    argv = ["prog"] + args + ["-o", "out/o1.fq", "--failed_out", "f.fq"]
    if "-I" in args or "--interleaved_in" in args:
        argv += ["-O", "o2.fq", "--merge", "--merged_out", "m.fq"]
    opt = cli.options_from_args(cli.build_parser().parse_args(argv[1:]), argv)
    assert multihost.active() and multihost.process_index() == k \
        and multihost.process_count() == n
    multihost.shard_options(opt)
    return {"range1": opt.shardRange1, "range2": opt.shardRange2,
            "records": getattr(opt, "shardRecRange", None),
            "out1": opt.out1, "out2": opt.out2, "failed": opt.failedOut,
            "merged": opt.merge.out}


@pytest.mark.parametrize("kind", ["plain", "se", "gz", "interleaved"])
def test_shard_options_are_equal(shard_corpus, kind, monkeypatch):
    seen = []
    for k in range(3):
        ours = _sharded_options(t_cli, t_multihost, shard_corpus[kind], k, 3,
                                monkeypatch)
        assert ours == _sharded_options(j_cli, j_multihost, shard_corpus[kind],
                                        k, 3, monkeypatch)
        assert ours["out1"] == os.path.join("out", "%04d.o1.fq" % (k + 1))
        assert ours["failed"] == "%04d.f.fq" % (k + 1)
        seen.append(ours)
    if kind == "gz":
        assert [s["records"] for s in seen] == [(0, 233), (233, 466), (466, None)]
    else:
        assert all(s["records"] is None for s in seen)
        assert seen[0]["range1"][0] == 0
        assert all(a["range1"][1] == b["range1"][0]
                   for a, b in zip(seen, seen[1:]))
    if kind == "interleaved":   # cut at even records: a pair stays whole
        path = shard_corpus[kind][1]
        lines = t_multihost._newlines_before(path, [s["range1"][0] for s in seen])
        assert all(c % 8 == 0 for c in lines)


def test_shard_options_refuse_split_and_stdin(monkeypatch):
    monkeypatch.setenv("FASTP_TPU_SHARD_INDEX", "0")
    monkeypatch.setenv("FASTP_TPU_SHARD_COUNT", "2")
    for args in (["-i", R1, "-s", "3", "-o", "o.fq"], ["--stdin"]):
        for cli, multihost in ((t_cli, t_multihost), (j_cli, j_multihost)):
            argv = ["prog"] + args
            opt = cli.options_from_args(cli.build_parser().parse_args(argv[1:]),
                                        argv)
            with pytest.raises(SystemExit):
                multihost.shard_options(opt)


def test_not_sharded_without_the_variables(monkeypatch):
    monkeypatch.delenv("FASTP_TPU_SHARD_INDEX", raising=False)
    monkeypatch.delenv("FASTP_TPU_SHARD_COUNT", raising=False)
    assert not t_multihost.active()
    assert (t_multihost.process_index(), t_multihost.process_count()) == (0, 1)


SHARD_CHILD = r"""
import os, pickle, sys
which, k, n, out = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
os.environ["FASTP_TPU_SHARD_INDEX"], os.environ["FASTP_TPU_SHARD_COUNT"] = k, n
if which == "port":
    import fastp_tpu_torch.cli as cli
    import fastp_tpu_torch.parallel.multihost as multihost
else:
    import fastp_tpu.cli as cli
    import fastp_tpu.parallel.multihost as multihost
argv = ["prog"] + sys.argv[5:]
opt = cli.options_from_args(cli.build_parser().parse_args(argv[1:]), argv)
multihost.shard_options(opt)
verdicts = multihost.exact_dedup_verdicts(opt)
first = multihost._allgather_bytes_files(b"first of %s" % k.encode(), os.getcwd())
second = multihost._allgather_bytes_files(pickle.dumps(verdicts), os.getcwd())
states = multihost.allgather_state({"k": int(k), "sum": int(verdicts.sum())},
                                   os.getcwd())
with open(out, "wb") as fh:
    pickle.dump((verdicts, first, [pickle.loads(s) for s in second], states), fh)
"""


def _run_shards(which, d, args, n=2):
    """n processes, each a shard: the dedup verdicts and three further
    rounds of the file exchange.  Returns each shard's pickled results."""
    import pickle
    d.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_CHILD, which, str(k), str(n),
         "result.%d" % k] + args + ["-j", str(d / "fastp.json")],
        cwd=str(d), env=env, stderr=subprocess.PIPE, text=True)
        for k in range(n)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    out = []
    for k in range(n):
        with open(d / ("result.%d" % k), "rb") as fh:
            out.append(pickle.load(fh))
    left = [f for f in os.listdir(d) if f.startswith(".fastp_shard")]
    assert left == [], left
    return out


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_exact_dedup_verdicts_and_file_exchange_are_equal(shard_corpus, kind,
                                                          tmp_path):
    args = shard_corpus[kind] + ["--dedup"]
    ours = _run_shards("port", tmp_path / "port", args)
    theirs = _run_shards("jax", tmp_path / "jax", args)
    total = 0
    for k, (mine, other) in enumerate(zip(ours, theirs)):
        assert np.array_equal(mine[0], other[0]) and mine[0].dtype == other[0].dtype
        assert mine[1] == other[1] == [b"first of 0", b"first of 1"]
        assert all(np.array_equal(a, b) for a, b in zip(mine[2], other[2]))
        # every shard holds every shard's verdicts after the exchange
        assert np.array_equal(mine[2][k], mine[0])
        assert mine[3] == other[3] == [
            {"k": i, "sum": int(ours[i][0].sum())} for i in range(2)]
        total += len(mine[0])
    assert total == 700
    assert 0 < sum(int(m[0].sum()) for m in ours) < 700   # some are duplicates


def test_batch_scan_and_args_are_equal(tmp_path):
    names = ["s1_R1.fastq.gz", "s1_R2.fastq.gz", "s2_R1.fq", "single.fastq",
             "Undetermined_R1.fq", "x.R1.fq", "x.R2.fq", "readme.txt",
             "s3_R2.fq"]
    for name in names:
        (tmp_path / name).write_text("")
    (tmp_path / "sub_R1.fq").mkdir()
    ours = t_batch.scan_dir(str(tmp_path))
    assert ours == j_batch.scan_dir(str(tmp_path))
    assert [(os.path.basename(a), b and os.path.basename(b)) for a, b in ours] == [
        ("s1_R1.fastq.gz", "s1_R2.fastq.gz"), ("s2_R1.fq", None),
        ("single.fastq", None), ("x.R1.fq", "x.R2.fq")]
    assert t_batch.scan_dir(str(tmp_path / "none")) == j_batch.scan_dir(
        str(tmp_path / "none")) == []
    assert t_batch.scan_dir(str(tmp_path), "s1", "s2") \
        == j_batch.scan_dir(str(tmp_path), "s1", "s2")
    for job in ours:
        for out_dir in (str(tmp_path / "o"), None):
            assert t_batch.build_args(job, out_dir, "rep", ["-q", "20"]) \
                == j_batch.build_args(job, out_dir, "rep", ["-q", "20"])
    for name, flag in (("a_R1.fq", "R1"), ("aR1b.fq", "R1"), ("a_R1_.fq", "R1_")):
        assert t_batch.match_flag(name, flag) == j_batch.match_flag(name, flag)
    assert t_batch.base_name("a.fq.gz") == j_batch.base_name("a.fq.gz") == "a"
    assert t_batch.base_name("a.txt") is None


def test_batch_summary_html_is_equal(tmp_path):
    """Both runners' overall.html over the goldens' reports, but for the
    program's name in it."""
    for which, mod in (("port", t_batch), ("jax", j_batch)):
        d = tmp_path / which
        d.mkdir()
        for name in ("cfg1_se_default", "cfg3_pe_correction", "cfg5_merge"):
            shutil.copy(os.path.join(ROOT, "tests", "golden", name, "fastp.json"),
                        d / (name + ".json"))
        with contextlib.redirect_stdout(io.StringIO()):
            mod.generate_summary_html(str(d))
    with open(tmp_path / "port" / "overall.html") as fa, \
            open(tmp_path / "jax" / "overall.html") as fb:
        ours, theirs = fa.read(), fb.read()
    assert "cfg3_pe_correction" in ours and len(ours) > 2000
    assert ours.replace("fastp_tpu_torch", "fastp_tpu") == theirs


def test_server_frames_are_equal():
    """A frame written by either server module is read by the other's
    recv_exact and by the port's client; both stream stand-ins frame text
    and bytes alike."""
    import fastp_tpu_torch.client as t_client
    payload = os.urandom(70000)
    for send in (t_server.send_frame, j_server.send_frame):
        a, b = socket.socketpair()
        writer = threading.Thread(target=lambda: (
            send(a, b"O", payload), send(a, b"R", b'{"rc": 3}'), a.close()))
        writer.start()
        got = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            got += chunk
        writer.join()
        b.close()
        assert got == (b"O" + (70000).to_bytes(4, "little") + payload
                       + b"R" + (9).to_bytes(4, "little") + b'{"rc": 3}')
    for recv in (t_server.recv_exact, j_server.recv_exact, t_client._recv_exact):
        a, b = socket.socketpair()
        a.sendall(b"abcdef")
        a.close()
        assert recv(b, 4) == b"abcd" and recv(b, 2) == b"ef"
        with pytest.raises(ConnectionError):
            recv(b, 1)
        b.close()
    frames = []
    for mod in (t_server, j_server):
        a, b = socket.socketpair()
        stream = mod._SockStream(a, b"E")
        stream.write("text\n")
        stream.buffer.write(b"\x00bytes")
        stream.write("")
        a.close()
        frames.append(b.recv(100))
        b.close()
        null = mod._NullStream()
        assert null.write("abc") == 3 and null.buffer is null
    assert frames[0] == frames[1] and frames[0].startswith(b"E\x05\x00\x00\x00text\n")


def test_self_test_prints_the_same_lines():
    import torch
    texts = []
    for run in (lambda: t_selftest.run_self_tests(torch.device("cpu")),
                j_selftest.run_self_tests):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert run() is True
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].count(": PASSED\n") == 11 and texts[0].endswith("ALL PASSED\n")
