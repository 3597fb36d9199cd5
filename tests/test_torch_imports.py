"""The port never imports JAX or the JAX package, and picks the card
unless told otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import kueue_tpu_torch
names = ["kueue_tpu_torch"]
for mod in pkgutil.walk_packages(kueue_tpu_torch.__path__, "kueue_tpu_torch."):
    names.append(mod.name)
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (as a module: main() does not run)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kueue_tpu"))
print(len(names))
print(",".join(leaked))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split("\n") + [""] * (
        2 - len(out.stdout.strip().split("\n")))
    assert int(count) >= 20  # every module of the package was imported
    assert leaked == "", f"imported: {leaked}"


def test_entry_points_default_to_the_card():
    from kueue_tpu_torch.device import resolve
    from kueue_tpu_torch.solver import BatchSolver
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSolver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    assert BatchSolver(device="cpu").device == torch.device("cpu")
