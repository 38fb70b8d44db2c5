"""The port's offline trace/metrics reader vs the JAX package's.

``repro_torch.obs.report`` is a copy of ``repro.obs.report``. Both read the
same files: the ``--trace`` and ``--metrics`` files of a port replay on the
torch tier (on the CPU), plain and under chaos, and those of a JAX replay;
the lines must be identical. ``python -m repro_torch.obs report`` prints
them.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.obs import report as jreport
from repro.service.__main__ import main as jax_cli
from repro_torch.obs import report
from repro_torch.service.__main__ import main as cli_main
from torch_threads import one_thread

one_thread()

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _artifacts(tmp_path, main, argv):
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    assert main([*argv, "--trace", t, "--metrics", m,
                 "--out", str(tmp_path / "r.json")]) == 0
    return t, m


@pytest.mark.parametrize("argv", (
    ["--device", "cpu", "--tenants", "6", "--duration", "3600"],
    ["--device", "cpu", "--tenants", "6", "--duration", "3600", "--policy", "oef-coop"],
    ["--device", "cpu", "--tenants", "6", "--duration", "3600", "--chaos",
     "--host-failures-per-hour", "2"],
), ids=("noncoop", "coop", "chaos"))
def test_report_lines_match_jax_reader_on_port_files(tmp_path, argv):
    t, m = _artifacts(tmp_path, cli_main, argv)
    lines = report.report_lines([t, m])
    assert lines == jreport.report_lines([t, m])
    text = "\n".join(lines)
    assert "resolve;solve" in text and "resolve;placement" in text
    assert "metrics summary" in text


def test_port_reader_reads_jax_files(tmp_path):
    t, m = _artifacts(tmp_path, jax_cli, ["--tenants", "5", "--duration", "3600",
                                          "--backend", "numpy"])
    assert report.report_lines([t, m]) == jreport.report_lines([t, m])


def test_pieces_match_jax_reader(tmp_path):
    t, m = _artifacts(tmp_path, cli_main, ["--device", "cpu", "--tenants", "6",
                                           "--duration", "3600", "--audit-every", "1"])
    doc = report.load_chrome_trace(t)
    rows = report.span_paths(doc)
    assert rows == jreport.span_paths(jreport.load_chrome_trace(t))
    assert report.stage_stats(rows) == jreport.stage_stats(rows)
    samples = report.load_metrics_jsonl(m)
    assert samples == jreport.load_metrics_jsonl(m)
    assert report.fairness_series(samples) == jreport.fairness_series(samples)
    assert report.fairness_series(samples)
    with pytest.raises(ValueError, match="not a metrics sample row"):
        report.load_metrics_jsonl(t)
    assert report.classify(t) == jreport.classify(t) == "trace"
    assert report.classify(m) == jreport.classify(m) == "metrics"


def test_obs_cli_reports_on_port_files(tmp_path):
    t, m = _artifacts(tmp_path, cli_main, ["--device", "cpu", "--tenants", "4",
                                           "--duration", "1800"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report", t, m],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == report.report_lines([t, m])
    with open(t) as f:
        assert "traceEvents" in json.load(f)
