"""The port stands alone: it never loads jax, and chip_smoke.py refuses to
run (non-zero exit, no result line) without a CUDA card or outside a
checkout. Each check runs in a fresh interpreter."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "infinitevl_tpu_torch"
ENV = {**os.environ, "PYTHONPATH": str(REPO)}

NO_JAX_PROGRAM = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import infinitevl_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from infinitevl_tpu_torch.config import tiny_config
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.params import init_text_params
torch.set_num_threads(1)
cfg = tiny_config()
params = {"text": init_text_params(cfg.text, torch.Generator().manual_seed(0), "cpu",
                                   torch.float32)}
out = Generator(params, cfg).generate(np.arange(20)[None] % 400, max_new_tokens=3)
assert out.shape == (1, 3), out.shape
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", loaded)
"""


def test_port_never_loads_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_PROGRAM], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_no_jax_import_lines_in_the_port():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_chip_smoke_refuses_without_cuda():
    # no card visible to the child, whatever this machine has
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env={**ENV, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
