#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

Drives ``repro_torch`` (never the JAX package) in phases; any failed check
raises and the script exits non-zero:

1. build the water-filling kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a``;
2. hold the kernel against its plain torch version on the card, on seeded
   staircase instances (n_pad 8..8192, k 3 and 4, T 1 and 8) at
   atol = rtol = 1e-12, and time both at the service's shape (n_pad 1024,
   k 3, T 8);
3. the solve tier at n = 1024, k = 3, cold and warm-started, against the
   same solve on the CPU (the plain version: tau and X within 1e-9) and the
   port's numpy greedy (see ``agree``), counting launches per solve;
4. the online service at full size: 1024 tenants on 1024+1024+1024 devices,
   ``oef-noncoop`` on the ``torch`` backend on ``cuda``. Every solve must
   come from ``torch`` with no LP fallback, no degraded solve and no
   ``solver_floor``, the kernel must have been launched exactly 14 times
   per cold and 15 per warm-started solve, every solved instance must agree
   with the CPU solve and the numpy greedy, and a second replay must repeat
   the first report bit for bit (less its wall-clock latency fields);
5. 128 tenants on 128x3 devices, replayed with the ``numpy`` backend, the
   ``torch`` backend on the card and the ``torch`` backend on the CPU (the
   plain version). The card and CPU replays must match as the JAX tier's
   replay test matches numpy, and every instance the card solved must agree
   with the CPU solve and the numpy greedy. The numpy replay is held to the
   card's within ``NUMPY_REL`` on solves, finished jobs, events and total
   tenant throughput, not to the same decisions: identical tenants get shares that differ
   by ~1e-10 between the two solvers, which flips largest-remainder rounding
   ties (the JAX tier's replay departs from numpy at this size in the same
   way).

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Details (flame summary of the second
full-size replay, per-phase numbers) go to ``chiprun_out/chip_smoke.json``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
#: FP64 rate outside the tensor cores, which is what the kernel's FP64
#: arithmetic runs on.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

TOL = 1e-12      # kernel vs plain version (as the JAX kernel test)
PARITY = 1e-9    # solve on the card vs the same solve on the CPU
#: numpy replay vs the card replay at 128 tenants (phase 5): relative
#: difference allowed in solves, finished jobs, events and the tenants'
#: total throughput. (Mean JCT is not held: it averages over the jobs that
#: finish inside the horizon, and two jobs more or less move it by ~6%.)
NUMPY_REL = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def staircase(rng, n: int, k: int, np):
    """Seeded Monge instance with service-like widths: speedups in [1, ~3],
    capacities between n/4 and n devices per type."""
    a = 1.0 + 2.0 * np.cumsum(rng.uniform(0.05, 0.8, size=n)) / n
    c = np.cumsum(rng.uniform(0.2, 0.6, size=k))
    c = c - c[0]
    W = np.power(a[:, None], c[None, :])
    m = rng.integers(n // 4 + 1, n + 1, size=k).astype(np.float64)
    return W, m


def paper_instance(rng, n: int, np):
    """n tenants drawn from the paper's six job types (k = 3)."""
    from repro_torch.core.profiler import PAPER_WORKLOAD_SPEEDUPS as P

    names = sorted(P)
    return np.array([P[names[i]] for i in rng.integers(len(names), size=n)])


def graph_ms(torch, fn, reps: int = 50, rounds: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``rounds`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def call_ms(torch, fn, reps: int = 200) -> float:
    """Time of one ``fn()`` call as a caller sees it (host launch included):
    ``reps`` back-to-back calls between CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def service_replay(n_tenants: int, scale: int, backend: str, device: str,
                   until: float, record=None, tracer=None):
    """One replay as ``benchmarks/service_throughput.py`` builds it."""
    from repro_torch import obs
    from repro_torch.core import backends
    from repro_torch.core.types import ClusterSpec
    from repro_torch.service import OnlineScheduler, synthetic_trace
    from repro_torch.service.traces import default_job_types

    cluster = ClusterSpec(types=("rtx3070", "rtx3080", "rtx3090"),
                          m=(8 * scale, 8 * scale, 8 * scale))
    events = synthetic_trace(
        n_tenants, job_types=default_job_types("paper"), cluster=cluster,
        duration_s=1800.0, mean_interarrival_s=1200.0, mean_work_s=1200.0,
        seed=0)
    sched = OnlineScheduler(cluster, "oef-noncoop", min_resolve_interval_s=30.0,
                            solver_backend=backend, device=device)

    def hook(program, backend_name, W, m):
        record.append((backend_name, W.copy(), m.copy()))

    if record is not None:
        backends.add_dispatch_hook(hook)
    if tracer is not None:
        obs.set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        report = sched.run(events, until=until)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if record is not None:
            backends.remove_dispatch_hook(hook)
    return sched, report, time.perf_counter() - t0


def decision_fields(report) -> dict:
    d = json.loads(report.to_json())
    return {k: v for k, v in d.items() if not k.startswith("resolve_latency")}


def agree(W, m, tau, X, np) -> float:
    """Hold a solve on the card against the CPU and the numpy greedy.

    The CPU solve runs the same multisection with the plain version, so tau
    and X must agree within 1e-9. The numpy greedy bisects to ~1e-13, while
    the multisection accepts a tau whose leftover mass is within
    1e-12*(1+n*tau), a few 1e-12 above the optimum; every user's share then
    carries that tau error and the boundary user absorbs the sum, up to
    n*|dtau|/min(W) devices (4e-9 at n = 1024 for the JAX tier as well). So
    against numpy tau must agree within 1e-9 and X within
    1e-9 + n*|dtau|/min(W). Returns the largest difference found.
    """
    from repro_torch.core import oef
    from repro_torch.core.torch_solve import solve_noncoop_fast_torch

    tau_c, X_c = solve_noncoop_fast_torch(W, m, device="cpu")
    d_cpu = max(abs(tau - tau_c), float(np.abs(X - X_c).max()))
    check(d_cpu <= PARITY, f"card vs CPU solve differ by {d_cpu:.3e}")
    ref = oef.solve_noncoop_waterfill(W, m)
    d_tau = abs(tau - ref.meta["tau"])
    d_x = float(np.abs(X - ref.X).max())
    allow = PARITY + W.shape[0] * d_tau / float(W.min())
    check(d_tau <= PARITY and d_x <= allow,
          f"vs numpy greedy: |dtau| {d_tau:.3e}, |dX| {d_x:.3e} > {allow:.3e}")
    return max(d_cpu, d_tau, d_x)


def instances_agree(record, np) -> float:
    """Re-solve every recorded instance on the card (cold) and hold it
    against the CPU and numpy (see ``agree``); returns the largest
    difference."""
    from repro_torch.core.torch_solve import solve_noncoop_fast_torch

    worst = 0.0
    for _backend, W, m in record:
        tau, X = solve_noncoop_fast_torch(W, m, device="cuda")
        worst = max(worst, agree(W, m, tau, X, np))
    return worst


def percentile(vals, q, np) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.core import oef, torch_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels import waterfill as wf

    ITERS = torch_solve.ITERS  # launches per cold solve; one more when warm

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    detail = {"card": smi, "torch": torch.__version__}
    t_all = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build("waterfill")
    wf.load()
    build_s = time.perf_counter() - t0
    log(f"[1] built {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s")
    for line in _build.BUILD_LOG.get(lib_path, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")
    detail["build_s"] = build_s

    # -- 2. kernel vs plain version ---------------------------------------------
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = 0
    for n_pad in (8, 128, 1024, 8192):
        for k in (3, 4):
            W, m = staircase(rng, n_pad - n_pad // 4, k, np)
            _, Wf, m64, mask = torch_solve._prepare(W, m)
            check(Wf.shape[0] == n_pad, f"bucket of {W.shape[0]} is {Wf.shape[0]}")
            hi = float((Wf * mask[:, None]).max(axis=0) @ m64 / mask.sum()) + 1.0
            for T in (1, 8):
                taus = hi * np.arange(1, T + 1) / (T + 1.0)
                ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                       for a in (taus, Wf, m64, mask)]
                got = wf.waterfill_masses(*ops)
                ref = wf.waterfill_masses_plain(*(o[None] for o in ops))[0]
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)
                max_err = max(max_err, float((got - ref).abs().max()))
                cases += 1
    log(f"[2] kernel == plain on {cases} cases (atol=rtol={TOL:g}), "
        f"max |diff| {max_err:.3e}")
    n_pad, k, T = 1024, 3, 8
    W, m = staircase(np.random.default_rng(1), n_pad, k, np)
    _, Wf, m64, mask = torch_solve._prepare(W, m)
    hi = float((Wf * mask[:, None]).max(axis=0) @ m64 / mask.sum()) + 1.0
    ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (hi * np.arange(1, T + 1) / (T + 1.0), Wf, m64, mask)]
    batched = [o[None] for o in ops]
    kernel_ms = graph_ms(torch, lambda: wf._launch(*batched))
    plain_ms = graph_ms(torch, lambda: wf.waterfill_masses_plain(*batched))
    kernel_call_ms = call_ms(torch, lambda: wf.waterfill_masses(*ops))
    n_bytes = (n_pad * k + n_pad + k + 2 * T) * 8
    n_ops = T * n_pad * k * 8
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP64_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"    n_pad={n_pad} k={k} T={T}: kernel {kernel_ms * 1e3:.2f} us "
        f"(graph replay; {kernel_call_ms * 1e3:.2f} us per wrapper call), "
        f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e6:.2f} ns "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    detail["kernel"] = {"cases": cases, "max_abs_err": max_err,
                        "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bytes": n_bytes, "fp64_ops": n_ops}

    # -- 3. solve tier vs numpy greedy ----------------------------------------
    W = paper_instance(np.random.default_rng(2), 1024, np)
    m = np.full(3, 1024.0)
    tau_ref = oef.solve_noncoop_waterfill(W, m).meta["tau"]
    per_solve = {}
    for label, hint in (("cold", None), ("warm", tau_ref * (1 - 1e-3))):
        before = wf.waterfill_masses.launches
        got = oef.solve_noncoop_waterfill_torch(W, m, tau_hint=hint, device="cuda")
        per_solve[label] = wf.waterfill_masses.launches - before
        worst = agree(W, m, got.meta["tau"], got.X, np)
        check(got.meta["warm_started"] is (hint is not None), f"{label}: warm flag")
        log(f"[3] {label} solve n=1024 k=3: |dtau| "
            f"{abs(got.meta['tau'] - tau_ref):.3e}, largest difference vs CPU "
            f"and numpy {worst:.3e}, {per_solve[label]} launches")
    check(per_solve == {"cold": ITERS, "warm": ITERS + 1},
          f"launches per solve {per_solve}, want cold {ITERS} / warm {ITERS + 1}")
    detail["launches_per_solve"] = per_solve

    # -- 4. the service at full size ----------------------------------------
    from repro_torch import obs

    torch_solve.prewarm(1024, 3, device="cuda")
    record = []
    wf.waterfill_masses.launches = 0
    sched, report, wall = service_replay(1024, 128, "torch", "cuda", 1200.0,
                                         record=record)
    launches = wf.waterfill_masses.launches
    solved = [s for s in sched.metrics.solves if not s.reused]
    warm = sum(1 for s in solved if s.warm_started)
    expected = ITERS * len(solved) + warm
    anomalies = report.anomalies
    log(f"[4] 1024 tenants / 3072 devices, until 1200 s: {report.n_solves} solves "
        f"({len(solved)} solved, {warm} warm), {report.n_events} events, "
        f"{report.jobs_finished} jobs finished, wall {wall:.1f} s, "
        f"{launches} kernel launches (want {expected})")
    check(set(report.solver_backends) == {"torch"},
          f"solver_backends {report.solver_backends}")
    check(report.fallback_count == 0, f"fallback_count {report.fallback_count}")
    check(report.degraded_solves == 0, f"degraded_solves {report.degraded_solves}")
    check("solver_floor" not in anomalies, f"anomalies {anomalies}")
    check(len(solved) >= 30, f"only {len(solved)} non-reused solves")
    check(launches == expected, f"{launches} launches, want {expected}")
    check(all(np.isfinite(list(report.steady_state_estimate.values()))),
          "non-finite throughput estimate")
    worst = instances_agree(record, np)
    lat = [s.latency_s * 1e3 for s in solved]
    solve_share = sum(s.latency_s for s in sched.metrics.solves) / wall
    log(f"    resolve_latency_ms mean {report.resolve_latency_ms_mean:.3f} "
        f"p95 {report.resolve_latency_ms_p95:.3f} (all solves); non-reused mean "
        f"{float(np.mean(lat)):.3f} p95 {percentile(lat, 95, np):.3f}; "
        f"solver share of wall {solve_share:.3f}; {len(record)} instances "
        f"agree with CPU and numpy (largest difference {worst:.3e})")
    tracer = obs.Tracer()
    _, report2, wall2 = service_replay(1024, 128, "torch", "cuda", 1200.0,
                                       tracer=tracer)
    check(decision_fields(report) == decision_fields(report2),
          "second full-size replay differs from the first")
    stats = tracer.flame_stats()
    top = sorted(stats.items(), key=lambda kv: -kv[1]["total_s"])[:12]
    log(f"    second replay identical (wall {wall2:.1f} s, traced)")
    detail["service_1024"] = {
        "n_solves": report.n_solves, "solved": len(solved), "warm": warm,
        "n_events": report.n_events, "jobs_finished": report.jobs_finished,
        "wall_s": wall, "traced_wall_s": wall2, "launches": launches,
        "resolve_latency_ms_mean": report.resolve_latency_ms_mean,
        "resolve_latency_ms_p95": report.resolve_latency_ms_p95,
        "solved_latency_ms_mean": float(np.mean(lat)),
        "solved_latency_ms_p95": percentile(lat, 95, np),
        "solver_share_of_wall": solve_share, "max_diff": worst,
        "flame_top": {p: s for p, s in top}}

    # -- 5. 128 tenants: numpy, torch on the card, torch on the CPU ---------------
    reports = {}
    record = []
    for label, backend, device, rec in (("numpy", "numpy", "cuda", None),
                                        ("cuda", "torch", "cuda", record),
                                        ("cpu", "torch", "cpu", None)):
        _, rep, w = service_replay(128, 16, backend, device, 7200.0, record=rec)
        reports[label] = rep
        log(f"[5] 128 tenants / 384 devices, {label:5s}: {rep.n_solves} solves, "
            f"{rep.jobs_finished} jobs, {rep.n_events} events, wall {w:.1f} s, "
            f"backends {rep.solver_backends}")
    a, b = reports["cpu"], reports["cuda"]
    check(set(b.solver_backends) == {"torch"} and b.fallback_count == 0,
          f"card replay backends {b.solver_backends}")
    check((a.n_solves, a.jobs_finished, a.n_events)
          == (b.n_solves, b.jobs_finished, b.n_events),
          "card and CPU torch replays made different decisions")
    check(abs(a.mean_jct_s - b.mean_jct_s) <= 1e-6 * max(a.mean_jct_s, 1.0),
          "mean JCT differs")
    d_tp = max(abs(a.tenant_throughput[t] - b.tenant_throughput[t])
               for t in a.tenant_throughput)
    check(d_tp <= 1e-6, f"tenant throughput differs by {d_tp:.3e}")
    c = reports["numpy"]
    for what, x, y in (("solves", c.n_solves, b.n_solves),
                       ("jobs finished", c.jobs_finished, b.jobs_finished),
                       ("events", c.n_events, b.n_events),
                       ("total throughput", sum(c.tenant_throughput.values()),
                        sum(b.tenant_throughput.values()))):
        check(abs(x - y) <= NUMPY_REL * max(abs(y), 1.0),
              f"numpy replay's {what} {x} vs the card's {y}: more than "
              f"{NUMPY_REL:.0%} apart")
    worst5 = instances_agree(record, np)
    log(f"    card == CPU replay (throughput diff {d_tp:.3e}), numpy replay "
        f"within {NUMPY_REL:.0%}; {len(record)} "
        f"instances agree with CPU and numpy (largest difference {worst5:.3e})")
    detail["service_128"] = {
        k: {"n_solves": r.n_solves, "jobs_finished": r.jobs_finished,
            "n_events": r.n_events} for k, r in reports.items()}
    detail["service_128"]["max_diff"] = worst5
    detail["total_s"] = time.perf_counter() - t_all

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, sort_keys=True)
    log(f"total {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "waterfill_masses",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:49",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
