"""The port imports torch and numpy, never jax and never pbrlab_tpu."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["pbrlab_tpu"] = None
import pbrlab_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pbrlab_tpu_torch.__path__,
                                               "pbrlab_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k.startswith("jax") for k, v in sys.modules.items() if v)
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported
