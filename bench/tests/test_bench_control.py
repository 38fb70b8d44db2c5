"""The control (the reference in the program's place, in float8 where the
configuration states bfloat16) and, for training, the half-batch fault,
read at smoke size: each fails a number by at least three times what the
program reads at the same size, so a limit between them separates them.
``bench/controls.py`` reads them at the cells' own sizes on the card."""
import pytest
import torch

import bench_smoke as S
from bench.harness import cli, control


@pytest.mark.parametrize("cell", S.cells())
def test_the_control_is_separated_from_the_program(cell):
    w = S.MAN.cell(cell)
    cfg, t = S.config(w["config"]), S.traffic(cell)
    sound = cli.run_cell(S.MAN, cell, 11, 0.1, False, "cpu", cfgfile=cfg, traffic=t)
    prog = {k: v["value"] for k, v in sound["compared"].items()}
    read = control.train_control if t["kind"] == "train" else control.prefill_control
    for name, numbers in read(cfg, t, 11, torch.device("cpu")).items():
        assert any(numbers[k] >= 3 * prog[k] and numbers[k] > 0 for k in prog), (name,
                                                                                  numbers, prog)
