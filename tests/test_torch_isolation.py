"""The port stands alone: no jax, nothing of the JAX package.

``repro_torch`` and ``chip_smoke.py`` must run on a machine without JAX, so
no module of the port may import ``jax`` or anything under ``repro``, not
even a module of it that has no JAX in it. Checked twice: by importing every
module in a fresh interpreter and reading ``sys.modules``, and by scanning
every import statement of the sources.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")


def port_sources():
    paths = []
    for d, _, files in os.walk(PORT):
        paths += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(paths) + [os.path.join(ROOT, "chip_smoke.py")]


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch.core.torch_solve" in out["modules"]
    assert "repro_torch.kernels.waterfill" in out["modules"]
    assert "repro_torch.service.__main__" in out["modules"]


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_jax_or_repro(path):
    roots = imported_roots(path)
    assert not {"jax", "jaxlib", "repro"} & set(roots), (path, roots)
