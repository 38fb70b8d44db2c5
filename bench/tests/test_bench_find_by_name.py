"""A configuration, a traffic mix, a cell and a per-layer metric are new
files and entries, found by name: no file the benchmark has changes."""
import json
import os
import shutil

import bench_smoke as S
from bench.harness import cli, manifest

ROOT = S.MAN.root


def _digest(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(root, "bench")):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    before = _digest(ROOT)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new configuration, traffic mix, cell (with its limits) and metric
    cfg = S.config("xlstm350m")
    (tmp_path / "bench/configs/tiny_xlstm.json").write_text(json.dumps(cfg))
    mix = S.traffic(S.cells("train")[0])
    mix["batch"] = 4
    (tmp_path / "bench/traffic/train.tiny.json").write_text(json.dumps(mix))
    cell = "tiny_xlstm.train.tiny"
    (tmp_path / "bench/limits" / f"{cell}.json").write_text(
        json.dumps({"limits": {"loss_rel": 1.0, "grad_gap": 1.0, "change_gap": 1.0}}))
    (tmp_path / "bench/metrics/steps_traced.train.py").write_text(
        "def read(rec):\n    return float(rec['steps']) if rec['kind'] == 'train' else None\n")
    bench["configs"].append({"name": "tiny_xlstm", "source": "test", "why": "test",
                             "file": "bench/configs/tiny_xlstm.json", "reduced": []})
    bench["workloads"].append({"name": cell, "config": "tiny_xlstm", "traffic": "train.tiny",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "train_tokens_per_s" == m["name"]:
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "launcher",
                               "moves": "train_tokens_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    man = manifest.Manifest(str(tmp_path))
    assert man.config("tiny_xlstm") == cfg and man.traffic("train.tiny")["batch"] == 4
    assert [m["name"] for m in man.per_layer(cell)] == ["steps_traced.train"]
    assert {m["name"] for m in man.end_to_end(cell)} == {"train_tokens_per_s", "setup_s"}
    r = cli.run_cell(man, cell, 9, 0.1, True, "cpu")
    assert r["correct"] is True
    assert r["metrics"] == {"steps_traced.train": {"value": 2.0, "unit": "steps"}}
    r = cli.run_cell(man, cell, 9, 0.1, False, "cpu")
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert _digest(ROOT) == before
