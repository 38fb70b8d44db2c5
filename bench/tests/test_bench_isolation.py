"""Nothing a run loads is the JAX package or JAX, and the reference loads
nothing of the program. Top-level module names are compared whole:
``repro_torch`` begins with ``repro`` and is the program."""
import os
import subprocess
import sys

import pytest

import bench_smoke as S
from bench.harness import cli

ROOT = S.MAN.root
_PATH = f"import sys; sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}, {os.path.dirname(__file__)!r}]\n"


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", _PATH + code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch.models", "reprox", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert cli.forbidden_modules() == []
    for name, top in (("repro.core", "repro"), ("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
                      ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in cli.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    found = _python(
        "import bench_smoke as S\n"
        "from bench.harness import cli\n"
        "for cell in S.cells():\n"
        "    w = S.MAN.cell(cell)\n"
        "    cli.run_cell(S.MAN, cell, 3, 0.1, False, 'cpu', cfgfile=S.config(w['config']),"
        " traffic=S.traffic(cell))\n"
        "assert 'repro_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print(cli.forbidden_modules())\n")
    assert found == "[]"


def test_the_reference_loads_nothing_of_the_program():
    found = _python(
        "import torch, bench_smoke as S\n"
        "from bench.harness import control\n"
        "for cell in S.cells():\n"
        "    w = S.MAN.cell(cell); t = S.traffic(cell)\n"
        "    cfg = S.config(w['config'])\n"
        "    f = control.train_control if t['kind'] == 'train' else control.prefill_control\n"
        "    f(cfg, t, 5, torch.device('cpu'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    assert found == "[]"


@pytest.mark.parametrize("only_the_benchmark", [False, True], ids=["checkout", "bench-only"])
def test_a_run_without_a_card_or_without_the_program_prints_no_result(tmp_path,
                                                                      only_the_benchmark):
    import torch

    if torch.cuda.is_available() and not only_the_benchmark:
        pytest.skip("a card is present: the run would print its result")
    root = ROOT
    if only_the_benchmark:
        import shutil

        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        root = str(tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", S.cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
    if only_the_benchmark:
        assert "repro_torch" in out.stderr
