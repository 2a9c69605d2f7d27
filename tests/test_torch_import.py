"""fastp_tpu_torch imports and runs with JAX blocked.

A child process sets sys.modules['jax'] = None (so any `import jax` raises),
imports every module of the package, runs the cfg3 golden through
cli.main, and checks the outputs and that no JAX module was loaded.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, os, pkgutil, re, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import fastp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastp_tpu_torch.__path__,
                                               "fastp_tpu_torch.")]
names = [n for n in names if n != "fastp_tpu_torch.__main__"]
for n in names:
    importlib.import_module(n)
from fastp_tpu_torch import cli
root, golden = sys.argv[1], sys.argv[2]
data = os.path.join(root, "tests", "testdata")
rc = cli.main(["fastp_tpu_torch", "-i", os.path.join(data, "R1.fq"),
               "-I", os.path.join(data, "R2.fq"), "-o", "out1.fq",
               "-O", "out2.fq", "--correction", "--cut_right"])
assert rc == 0
for f in ("out1.fq", "out2.fq"):
    assert open(f, "rb").read() == open(os.path.join(golden, f), "rb").read(), f
norm = lambda t: re.sub(r'\t"command": ".*"', '\t"command": "X"', t)
assert norm(open("fastp.json").read()) == norm(
    open(os.path.join(golden, "fastp.json")).read())
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("IMPORTED", len(names))
"""


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    golden = os.path.join(ROOT, "tests", "golden", "cfg3_pe_correction")
    res = subprocess.run([sys.executable, "-c", CHILD, ROOT, golden],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "IMPORTED" in res.stdout
    n = int(res.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 14  # every ops and pipeline module, cli, cuda_build
