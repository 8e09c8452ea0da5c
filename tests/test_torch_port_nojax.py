"""The port imports neither JAX nor the JAX package.

Every module of ``gnn_motion_planning_tpu_torch`` and the module-level code
of ``chip_smoke.py`` are imported in a fresh interpreter in which ``jax``,
``jaxlib`` and ``gnn_motion_planning_tpu`` cannot be imported.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "gnn_motion_planning_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
import gnn_motion_planning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == b or m.startswith(b + ".") for m in sys.modules for b in BLOCKED)
print(len(names), "modules")
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", f"REPO = {str(REPO)!r}\n" + _PROBE],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_no_source_line_imports_jax():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gnn_motion_planning_tpu)\b")
    files = list((REPO / "gnn_motion_planning_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [
        f"{f}:{i}" for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)
    ]
    assert not offenders, offenders


def test_csrc_includes_no_torch_header():
    for f in (REPO / "gnn_motion_planning_tpu_torch" / "csrc").iterdir():
        text = f.read_text()
        assert "torch/" not in text and "pybind11" not in text and "ATen" not in text, f
