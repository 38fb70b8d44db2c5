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
from torch_threads import one_thread

one_thread()

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
    assert "repro_torch.core.torch_coop" in out["modules"]
    assert "repro_torch.kernels.envy" in out["modules"]
    assert "repro_torch.service.__main__" in out["modules"]
    assert "repro_torch.kernels.rglru_scan" in out["modules"]
    assert "repro_torch.models.model" in out["modules"]
    assert "repro_torch.configs" in out["modules"]
    assert "repro_torch.launch.serve" in out["modules"]
    assert "repro_torch.kernels.flash_attention" in out["modules"]
    assert "repro_torch.kernels.xent" in out["modules"]
    assert "repro_torch.kernels.ref" in out["modules"]
    for name in ("optim.optimizers", "data.pipeline", "checkpoint.manager",
                 "runtime.trainstep", "runtime.trainer", "launch.train",
                 "models.costs", "configs.qwen2_1_5b", "configs.gemma3_4b",
                 "configs.yi_9b", "configs.phi4_mini_3_8b", "configs.phi_3_vision_4_2b",
                 "configs.whisper_tiny", "configs.arctic_480b", "configs.kimi_k2_1t_a32b",
                 "core.elastic", "service.faults", "service.journal", "obs.report",
                 "obs.__main__", "examples.cluster_scheduler_e2e",
                 "examples.serve_decode", "examples.quickstart",
                 "examples.online_service", "optim.compress", "distributed",
                 "distributed.sharding", "distributed.zero", "distributed.parallel",
                 "launch.mesh"):
        assert f"repro_torch.{name}" in out["modules"]


def test_service_interop_loads_no_model_stack():
    """``interop``'s service helpers come without the serving model: its
    model converters import ``models`` only when called."""
    code = """
import json, sys
import repro_torch.interop
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith(("repro_torch.models", "repro_torch.configs")))))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


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
