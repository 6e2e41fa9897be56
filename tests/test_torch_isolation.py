"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

Importing every ``repro_torch`` module in a fresh interpreter leaves no
``jax`` module and no ``repro`` / ``repro.*`` module loaded (the port
copies the framework-free modules it needs rather than importing them).
``chip_smoke.py`` is held to the same rule.  The default device is the
card: without one, ``TorchBackend()`` raises instead of running on the
CPU.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.backend.surrogate import resolve_device
from repro_torch.backend.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    parts = [p.relative_to(PORT.parent).with_suffix("").parts
             for p in PORT.rglob("*.py")]
    want = {".".join(x[:-1] if x[-1] == "__init__" else x) for x in parts}
    assert want - {"repro_torch"} <= set(out["modules"])


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_repro(path):
    """Static check of every import statement, lazy ones included."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {mod}"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(block_size=8, num_blocks=4)
    assert resolve_device("cpu") == torch.device("cpu")
