"""hop_tpu_torch imports neither jax nor flax nor hop_tpu: a fresh process
imports every module of the port and runs its long-form entry point on
the CPU for one window at the tiny size."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import hop_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hop_tpu_torch.__path__,
                                                "hop_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from hop_tpu_torch.cli import test_checkpoint
out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2"])
assert out.shape == (34, 27), out.shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hop_tpu"))
print("MODULES", len(names), "FOREIGN", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generated 34 frames" in proc.stdout
    assert "FOREIGN []" in proc.stdout, proc.stdout
    n_modules = int(proc.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 15
