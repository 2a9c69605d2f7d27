"""fastp_tpu_torch imports and runs with JAX and fastp_tpu blocked.

A child process sets sys.modules[name] = None for jax, jaxlib and fastp_tpu
(so any import of them raises), imports every module of the package (the
SE processor in pipeline/runner.py and the merge op among them), runs the
cfg3, the merging cfg5 and the single-end cfg1 goldens through cli.main on
the CPU, and checks the outputs and that no module of the three was loaded.
A second, static test reads every source file of the port and
chip_smoke.py and fails on an import line that names fastp_tpu.  A third
reads the thin client's path (`__main__.py` up to its import of `.cli`, and
client.py): it imports the standard library only, so a served job never
pays for torch or numpy.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, os, pkgutil, re, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["fastp_tpu"] = None
import fastp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastp_tpu_torch.__path__,
                                               "fastp_tpu_torch.")]
names = [n for n in names if n != "fastp_tpu_torch.__main__"]
for n in names:
    importlib.import_module(n)
from fastp_tpu_torch import cli
from fastp_tpu_torch.pipeline.runner import SingleEndProcessor
root = sys.argv[1]
data = os.path.join(root, "tests", "testdata")
norm = lambda t: re.sub(r'\t"command": ".*"', '\t"command": "X"', t)
for name, args, outs in (
        ("cfg3_pe_correction", ["-I", os.path.join(data, "R2.fq"), "-o",
                                "out1.fq", "-O", "out2.fq", "--correction",
                                "--cut_right"], ("out1.fq", "out2.fq")),
        ("cfg5_merge", ["-I", os.path.join(data, "R2.fq"), "--merge",
                        "--merged_out", "merged.fq", "--out1", "out1.fq",
                        "--out2", "out2.fq", "--dedup", "--dup_calc_accuracy",
                        "1", "--overrepresentation_analysis"],
         ("merged.fq", "out1.fq", "out2.fq")),
        ("cfg1_se_default", ["-o", "out.fq"], ("out.fq",))):
    golden = os.path.join(root, "tests", "golden", name)
    rc = cli.main(["fastp_tpu_torch", "-i", os.path.join(data, "R1.fq")] + args,
                  device="cpu")
    assert rc == 0
    for f in outs:
        assert open(f, "rb").read() == open(os.path.join(golden, f), "rb").read(), f
    assert norm(open("fastp.json").read()) == norm(
        open(os.path.join(golden, "fastp.json")).read()), name
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "fastp_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("IMPORTED", len(names))
"""


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env.pop("FASTP_TPU_TORCH_DEVICE", None)  # the child passes device="cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")  # see test_torch_cli.run_module
    res = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "IMPORTED" in res.stdout
    n = int(res.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 41  # ops, pipeline, io, report, utils, parallel, cli, server, ...


IMPORT_LINE = re.compile(r"^\s*(?:from\s+(\S+)\s+import\b|import\s+(.+))")


def _imported_names(line):
    """The dotted module names an import line names, or []."""
    m = IMPORT_LINE.match(line)
    if not m:
        return []
    if m.group(1):
        return [m.group(1)]
    return [part.split(" as ")[0].strip()
            for part in m.group(2).split("#")[0].split(",")]


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "fastp_tpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_line_parser():
    assert _imported_names("from fastp_tpu.config import Options") == ["fastp_tpu.config"]
    assert _imported_names("    import os, fastp_tpu.cli as c  # x") == ["os", "fastp_tpu.cli"]
    assert _imported_names("from fastp_tpu_torch import cli") == ["fastp_tpu_torch"]
    assert _imported_names("from ..config import Options") == ["..config"]
    assert _imported_names("x = 'import fastp_tpu'") == []


def test_no_source_of_the_port_imports_fastp_tpu():
    sources = _port_sources()
    assert len(sources) >= 40
    bad = []
    for path in sources:
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                for name in _imported_names(line):
                    if name.split(".")[0] in ("fastp_tpu", "jax", "jaxlib"):
                        bad.append("%s:%d: %s" % (os.path.relpath(path, ROOT),
                                                  no, line.strip()))
    assert not bad, "\n".join(bad)
    # importlib and __import__ spelled with the package's name
    dynamic = re.compile(r"""(import_module|__import__)\(\s*["']fastp_tpu["'.]""")
    for path in sources:
        with open(path) as fh:
            assert not dynamic.search(fh.read()), path


def test_the_thin_clients_path_imports_the_standard_library_only():
    pkg = os.path.join(ROOT, "fastp_tpu_torch")
    with open(os.path.join(pkg, "__main__.py")) as fh:
        main_lines = fh.read().split("from .cli import main")[0].splitlines()
    with open(os.path.join(pkg, "client.py")) as fh:
        client_lines = fh.read().splitlines()
    assert len(main_lines) > 10 and len(client_lines) > 40
    names = {name for line in main_lines + client_lines
             for name in _imported_names(line)}
    assert {".client", ".server", "socket", "struct"} <= names
    allowed = set(sys.stdlib_module_names) | {"__future__", ".client", ".server"}
    assert names <= allowed, sorted(names - allowed)
    with open(os.path.join(pkg, "__init__.py")) as fh:
        assert not [n for line in fh for n in _imported_names(line)]
