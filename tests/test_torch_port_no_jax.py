"""The port stands without JAX: a fresh interpreter imports every module of
`exploremultimodal_torch` and `chip_smoke.py` (its imports; `main` does
not run), and neither `jax` nor `exploremultimodal_tpu` is loaded."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import importlib, pkgutil, sys
import exploremultimodal_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "exploremultimodal_tpu"))
print(len(names), loaded)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    count, loaded = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) > 40, proc.stdout
    assert loaded == "[]", loaded
