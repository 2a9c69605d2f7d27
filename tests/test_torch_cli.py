"""End-to-end runs of `python -m fastp_tpu_torch` on the CPU.

* the cfg3 golden (tests/golden/cfg3_pe_correction), and the PE default
  and NovaSeq goldens the same code covers: FASTQ byte for byte, JSON
  after the tests/test_parity.py normalisation;
* a differential run against `python -m fastp_tpu` on a 2,000-pair
  tools/make_synth.py corpus with the bench flags;
* the correction-slot overflow path (exact host recomputation) against the
  normal sparse path on the same corpus;
* the options that the port once refused (several devices, alone and
  with --local_processes) run and write their report; the split has its
  own file (tests/test_torch_mesh.py), as have the server, the self-test
  and --local_processes (tests/test_torch_server.py,
  test_torch_selftest.py, test_torch_local_processes.py);
* the device rule: CUDA unless the caller asks for the CPU (`device="cpu"`
  or FASTP_TPU_TORCH_DEVICE=cpu); no card and no request is an error.

The single-end and failure-routing paths have their own files
(tests/test_torch_se.py, tests/test_torch_failed.py), which reuse the
helpers here.
"""
import contextlib
import os
import re
import subprocess
import sys

import pytest
import torch

from fastp_tpu_torch import cli
from fastp_tpu_torch.ops import correct as t_correct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "golden")
R1 = os.path.join(ROOT, "tests", "testdata", "R1.fq")
R2 = os.path.join(ROOT, "tests", "testdata", "R2.fq")
BENCH = ["--correction", "--cut_right",
         "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
         "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
# files a run writes that are not compared: the log, and the HTML report,
# which embeds the command line (fastp.json holds the same numbers)
NOT_COMPARED = ("stderr.txt", "fastp.html")


def normalize_json(text):
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def assert_same_outputs(dir_a, dir_b):
    """Every output file of dir_b (a golden or a fastp_tpu run) is in dir_a
    with the same bytes; fastp.json after the command-line normalisation."""
    files = sorted(f for f in os.listdir(dir_b) if f not in NOT_COMPARED)
    assert "fastp.json" in files
    for f in files:
        with open(os.path.join(dir_a, f), "rb") as fa, \
                open(os.path.join(dir_b, f), "rb") as fb:
            a, b = fa.read(), fb.read()
        if f.endswith(".json"):
            assert normalize_json(a.decode()) == normalize_json(b.decode()), f
        else:
            assert a == b, f
    return files


def run_module(module, cwd, args, stdin=None, stdout=None, **env_extra):
    """Run `python -m module args` in cwd; `stdin` is a file to read from,
    `stdout` the name of a file in cwd that takes the standard output."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FASTP_TPU_TORCH_DEVICE"] = "cpu"  # the port's request for the CPU
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # one OpenMP thread per run: the suite runs files in parallel workers,
    # and a torch pool per process sized to every core oversubscribes the
    # host (with this and one_torch_thread below, the port's test files
    # take 94 s at -n 6 on an 8-core host; four of them took 549 s at -n 4
    # without)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(env_extra)
    with contextlib.ExitStack() as files:
        fin = files.enter_context(open(stdin, "rb")) if stdin else None
        fout = (files.enter_context(open(os.path.join(cwd, stdout), "wb"))
                if stdout else subprocess.PIPE)
        res = subprocess.run([sys.executable, "-m", module] + args,
                             cwd=str(cwd), env=env, stdin=fin, stdout=fout,
                             stderr=subprocess.PIPE, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch run inside the test process, for the
    reason given in run_module.  Test files that run torch in-process
    import this autouse fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_corpus(d, pairs=2000, seed=7):
    """A tools/make_synth.py PE151 corpus in directory d: (R1, R2) paths."""
    r1, r2 = str(d / "R1.fq"), str(d / "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", str(pairs), "--seed", str(seed),
                    "--out1", r1, "--out2", r2],
                   check=True, capture_output=True)
    return r1, r2


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 2,000-pair corpus and the port's run of it with the bench flags."""
    d = tmp_path_factory.mktemp("synth")
    r1, r2 = make_corpus(d)
    port = d / "port"
    port.mkdir()
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq"] + BENCH
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
    cli.run(["fastp_tpu_torch"] + args, device="cpu")
    assert max(counts) > 4
    assert_same_outputs(d / "port", tmp_path)


@pytest.mark.parametrize("argv,golden", [
    (["-i", R1, "-I", R2, "--devices", "2"], "cfg2_pe_default"),
    (["-i", R1, "--devices=4", "--local_processes", "2"], "cfg1_se_default"),
])
def test_options_outside_the_slice(argv, golden, tmp_path, monkeypatch):
    """No option is outside the port any more: what raised
    NotImplementedError runs, and its report is the golden's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    res = cli.run(["fastp_tpu_torch"] + argv, device="cpu")
    assert res.get("rc", 0) == 0
    with open(tmp_path / "fastp.json") as got, \
            open(os.path.join(GOLDENS, golden, "fastp.json")) as want:
        assert normalize_json(got.read()) == normalize_json(want.read())


def _module_run(cwd, args, **env_extra):
    """`python -m fastp_tpu_torch args` with the device request taken out of
    the environment unless env_extra puts one in; returns the finished
    process, whatever its exit code."""
    env = dict(os.environ)
    env.pop("FASTP_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "fastp_tpu_torch"] + args,
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=900)


CFG3 = ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq", "--correction",
        "--cut_right"]


def test_no_card_and_no_request_fails_at_once(tmp_path):
    """Without a card the port does not carry on on the CPU unasked: it
    exits non-zero, names the variable that asks for the CPU, and has
    written nothing."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the unasked run would use it")
    res = _module_run(tmp_path, CFG3)
    assert res.returncode != 0
    assert "FASTP_TPU_TORCH_DEVICE" in res.stderr
    assert "running on" not in res.stderr
    assert os.listdir(tmp_path) == []


def test_device_variable_asks_for_the_cpu(tmp_path):
    res = _module_run(tmp_path, CFG3, FASTP_TPU_TORCH_DEVICE="cpu")
    assert res.returncode == 0, res.stderr[-4000:]
    assert "running on cpu" in res.stderr
    assert_same_outputs(tmp_path, os.path.join(GOLDENS, "cfg3_pe_correction"))


@pytest.mark.parametrize("given,env,want", [
    ("cpu", None, "cpu"), (None, "cpu", "cpu"), ("cpu", "cuda", "cpu"),
    (torch.device("cpu"), None, "cpu")])
def test_resolve_device_takes_the_callers_word(given, env, want, monkeypatch):
    monkeypatch.delenv("FASTP_TPU_TORCH_DEVICE", raising=False)
    if env is not None:
        monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", env)
    assert cli.resolve_device(given) == torch.device(want)


@pytest.mark.parametrize("given,env", [
    (None, None), (None, ""), ("cuda", "cpu"), (None, "cuda:0")])
def test_resolve_device_never_falls_back(given, env, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("FASTP_TPU_TORCH_DEVICE", raising=False)
    if env is not None:
        monkeypatch.setenv("FASTP_TPU_TORCH_DEVICE", env)
    with pytest.raises(RuntimeError, match="FASTP_TPU_TORCH_DEVICE"):
        cli.resolve_device(given)


def test_resolve_device_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu, cuda"):
        cli.resolve_device("meta")

