"""fastp_tpu_torch imports and runs with JAX blocked.

A child process sets sys.modules['jax'] = None (so any `import jax` raises),
imports every module of the package (the SE processor in
pipeline/runner.py and the merge op among them), runs the cfg3, the
merging cfg5 and the single-end cfg1 goldens through cli.main, and checks
the outputs and that no JAX module was loaded.
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
    rc = cli.main(["fastp_tpu_torch", "-i", os.path.join(data, "R1.fq")] + args)
    assert rc == 0
    for f in outs:
        assert open(f, "rb").read() == open(os.path.join(golden, f), "rb").read(), f
    assert norm(open("fastp.json").read()) == norm(
        open(os.path.join(golden, "fastp.json")).read()), name
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("IMPORTED", len(names))
"""


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")  # see test_torch_cli.run_module
    res = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "IMPORTED" in res.stdout
    n = int(res.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 15  # every ops and pipeline module, cli, cuda_build
