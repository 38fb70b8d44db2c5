"""The harness end to end at smoke sizes on the plain paths (CPU), and on
the card where there is one."""
import json
import math
import os
import subprocess
import sys

import pytest

import bench_smoke as S
from bench.harness import cli

SEED = 2**33 + 7  # seeds run past 32 bits


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("cell", S.cells())
def test_a_cell_runs_its_whole_path_at_smoke_size(cell, traced):
    w = S.MAN.cell(cell)
    r = cli.run_cell(S.MAN, cell, SEED, 0.3, traced, "cpu",
                     cfgfile=S.config(w["config"]), traffic=S.traffic(cell))
    assert r["correct"] is True, r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= (2 if traced else 1)
    assert list(r)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in r["compared"].values())
    if traced:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in S.MAN.end_to_end(cell)}
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 and math.isfinite(v["value"]) for v in r["metrics"].values())
    json.loads(json.dumps(r))


def test_the_same_seed_gives_the_same_numbers():
    cell = S.cells("prefill")[0]
    w = S.MAN.cell(cell)
    runs = [cli.run_cell(S.MAN, cell, SEED, 0.1, False, "cpu", cfgfile=S.config(w["config"]),
                         traffic=S.traffic(cell))["compared"] for _ in range(2)]
    assert runs[0] == runs[1]


def test_p90_is_the_nearest_rank_and_counts_failures():
    assert cli.p90(list(range(1, 101))) == 90
    assert cli.p90([1.0] * 9 + [math.inf]) == 1.0
    assert cli.p90([1.0] * 8 + [math.inf] * 2) == math.inf


@pytest.mark.chip
def test_a_cell_runs_on_the_card(card):
    root = S.MAN.root
    cell = S.cells("prefill")[0]
    out = subprocess.run([sys.executable, os.path.join(root, "bench", "run.py"), "--workload",
                          cell, "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")


@pytest.mark.parametrize("change", [{"loop": {"kind": "open", "clients": 1}},
                                    {"loop": {"kind": "closed", "clients": 2}},
                                    {"draw": {"law": "uniform", "doc_len_mean": 512, "eos_id": 1}}],
                         ids=["open-loop", "two-clients", "uniform-draw"])
def test_traffic_the_harness_cannot_make_is_refused(change):
    from bench.harness import traffic

    t = dict(S.traffic(S.cells()[0]), **change)
    with pytest.raises(ValueError, match="cannot make"):
        traffic.pool(t, 500, SEED)
