"""The port's two fused solver kernels' wrappers and routes, on the CPU.

``repro_torch.kernels.envy.pd_segment`` (a whole PD segment of the
cooperative tier in one launch) and ``repro_torch.kernels.waterfill.
waterfill_solve`` (a whole water-filling solve in one launch) run their
plain versions on CPU tensors: ``pd_segment_plain`` must repeat the stepwise
segment the tier ran before the fused kernel bit for bit and agree with the
JAX tier's jitted segment within atol 1e-12 (the two sum in different
orders); ``waterfill_solve_plain`` must agree with the JAX tier's jitted
solve within 1e-9 on tau and X. Also the route rule (which segments take
the fused kernel), the wrappers' checks, the launch counts and the grad
guard. The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py`` (phases 3 and 6).
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import jax_coop, jax_solve
from repro_torch.core import torch_coop, torch_solve
from repro_torch.kernels import envy as tenvy
from repro_torch.kernels import waterfill as twf
from torch_threads import one_thread

one_thread()

SEGMENT_TOL = 1e-12  # the port's segment vs the JAX segment
PARITY_TOL = 1e-9    # the port's solve vs the JAX solve


def x64():
    """Float64 for the JAX calls (jax 0.9 removed the
    ``jax.experimental.enable_x64`` that ``jax_solve.x64_scope`` uses)."""
    return jax.enable_x64(True)


def catalog_instance(rng, n, g=5, k=3):
    """n tenants drawn from a g-profile catalog (tests/test_jax_coop.py)."""
    cat = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(g, k)), axis=1)
    cat /= cat[:, :1]
    return cat[rng.integers(0, g, size=n)], rng.uniform(1.0, 4.0, size=k) * n / 4


def distinct_instance(rng, n, k=3):
    W = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(n, k)), axis=1)
    W /= W[:, :1]
    return W, rng.uniform(1.0, 4.0, size=k) * n / 4


def segment_case(kind, n, k=3):
    """The padded operands and a zero state of one coop instance, as numpy
    (for the JAX segment) and as CPU tensors (for the port's)."""
    make = catalog_instance if kind == "catalog" else distinct_instance
    W, m = make(np.random.default_rng(n), n, k=k)
    Wd, _, cnt = torch_coop._reduce(W)
    G, Wp, cntp, _, pairm, tau, sig_env, sig_cap = torch_coop._padded_operands(Wd, cnt, k)
    consts = (Wp, cntp, m, pairm, tau, sig_env, sig_cap)
    state = (np.zeros((G, k)), np.zeros(k), np.zeros((G, G)))
    ops = torch_coop._device_operands(
        torch.device("cpu"), tuple(a[None] for a in consts[:6]) + (sig_cap,),
        *(a[None] for a in state))
    return consts, state, ops


def stepwise_segment(Wp, cnt, m, pairm, tau, sig_env, sig_cap, x, p, L, *, seg):
    """The cooperative tier's PD segment as it ran before the fused kernel:
    the reference ``pd_segment_plain`` must repeat bit for bit."""
    cnt3 = cnt[:, :, None]
    cvec = cnt3 * Wp
    sig3 = sig_env[:, :, None]
    xs, ps, Ls = torch.zeros_like(x), torch.zeros_like(p), torch.zeros_like(L)
    for _ in range(seg):
        AtY = (cnt3 * p[:, None, :] + L.transpose(1, 2) @ Wp
               - L.sum(dim=2)[:, :, None] * Wp)
        xn = torch.clamp_min(x + tau * (cvec - AtY), 0.0)
        xb = 2.0 * xn - x
        E = tenvy.envy_gaps_plain(Wp, xb) * pairm
        p = torch.clamp_min(p + sig_cap * ((cnt3 * xb).sum(dim=1) - m), 0.0)
        L = torch.clamp_min(L + sig3 * E, 0.0) * pairm
        x = xn
        xs += x
        ps += p
        Ls += L
    inv = 1.0 / seg
    return xs * inv, ps * inv, Ls * inv


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# the PD segment
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device,G,fused", (
    ("cuda", 1, True), ("cuda", 8, True), ("cuda", tenvy.PD_FUSED_MAX_G, True),
    ("cuda", tenvy.PD_FUSED_MAX_G + 1, False), ("cuda", 256, False),
    ("cpu", 8, False), ("cpu", tenvy.PD_FUSED_MAX_G, False), ("cuda:0", 32, True)))
def test_segment_route_takes_the_fused_kernel_on_the_card_up_to_the_limit(device, G, fused):
    assert tenvy.fused_segment(device, G) is fused
    assert tenvy.fused_segment(torch.device(device), G) is fused


def test_the_fused_limit_matches_the_kernel_source():
    import os

    from repro_torch.kernels import _build

    with open(os.path.join(_build.SRC_DIR, "envy.cu")) as f:
        src = f.read()
    assert f"constexpr int kPdMaxG = {tenvy.PD_FUSED_MAX_G};" in src
    assert f"constexpr int kMaxK = {tenvy.MAX_K};" in src


@pytest.mark.parametrize("kind,n", (("catalog", 40), ("distinct", 20), ("distinct", 64)))
@pytest.mark.parametrize("segment", ("pd_segment_plain", "pd_segment", "routed"))
def test_segment_repeats_the_stepwise_loop_and_matches_the_jax_segment(kind, n, segment):
    """One 250-step segment from a cold start, through the plain version,
    the fused kernel's wrapper (CPU tensors: the plain version) and the
    tier's routed segment: bit for bit the stepwise loop, and within 1e-12
    of the JAX tier's jitted segment on the same padded operands."""
    consts, state, ops = segment_case(kind, n)
    fn = {"pd_segment_plain": tenvy.pd_segment_plain, "pd_segment": tenvy.pd_segment,
          "routed": torch_coop._pd_segment}[segment]
    got = fn(*ops, seg=torch_coop.SEG_ITERS)
    for a, b in zip(got, stepwise_segment(*ops, seg=torch_coop.SEG_ITERS)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with x64():
        ref = [np.asarray(a) for a in jax_coop._pd_segment(*consts, *state)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a[0].numpy(), b, atol=SEGMENT_TOL, rtol=0)


def test_segment_of_a_batch_and_a_warm_state():
    """B = 2 instances of one bucket, from the state one segment left: the
    wrapper equals the stepwise loop bit for bit, per instance too."""
    _, _, a = segment_case("distinct", 20)
    _, _, b = segment_case("distinct", 24)
    ops = [torch.cat([x, y]) for x, y in zip(a, b)]
    state = tenvy.pd_segment_plain(*ops, seg=50)
    ops = ops[:7] + [s.contiguous() for s in state]
    got = tenvy.pd_segment(*ops, seg=50)
    for x, y in zip(got, stepwise_segment(*ops, seg=50)):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    one = tenvy.pd_segment(*(o[:1].contiguous() for o in ops), seg=50)
    for x, y in zip(got, one):
        torch.testing.assert_close(x[:1], y, atol=0, rtol=0)


def test_cpu_segment_never_reaches_the_fused_wrapper(monkeypatch):
    def unreachable(*_a, **_k):
        raise AssertionError("a CPU segment took the fused route")

    monkeypatch.setattr(torch_coop, "pd_segment", unreachable)
    _, _, ops = segment_case("catalog", 40)
    got = torch_coop._pd_segment(*ops, seg=20)
    for a, b in zip(got, tenvy.pd_segment_plain(*ops, seg=20)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_segment_counts_no_launch():
    _, _, ops = segment_case("catalog", 40)
    before = (tenvy.pd_segment.launches, tenvy.envy_gaps.launches)
    tenvy.pd_segment(*ops, seg=5)
    assert (tenvy.pd_segment.launches, tenvy.envy_gaps.launches) == before


NAMES = ("Wp", "cnt", "m", "pairm", "tau", "sig_env", "sig_cap", "x", "p", "L")


@pytest.mark.parametrize("bad", ("dtype", "shape", "contiguous", "device"))
@pytest.mark.parametrize("which", (0, 1, 3, 6, 9))
def test_segment_wrapper_rejects_a_malformed_operand_naming_it(bad, which):
    _, _, a = segment_case("distinct", 20)
    _, _, b = segment_case("distinct", 24)
    ops = [torch.cat([x, y]) for x, y in zip(a, b)]  # B = 2: no operand of one element
    t = ops[which]
    if bad == "dtype":
        ops[which] = t.float()
    elif bad == "shape":
        ops[which] = torch.cat([t, t], dim=-1)
    elif bad == "contiguous":
        ops[which] = torch.cat([t, t], dim=-1)[..., ::2]
    else:
        ops[which] = t.to("meta")
    with pytest.raises((TypeError, ValueError), match=NAMES[which]):
        tenvy.pd_segment(*ops, seg=3)


def test_segment_wrapper_rejects_G_and_k_above_its_limits_and_no_steps():
    G = tenvy.PD_FUSED_MAX_G + 1

    def ops(G, k):
        return [torch.zeros(s, dtype=torch.float64) for s in (
            (1, G, k), (1, G), (1, k), (1, G, G), (1, G, k), (1, G), (1, 1),
            (1, G, k), (1, k), (1, G, G))]

    with pytest.raises(ValueError, match=f"G <= {tenvy.PD_FUSED_MAX_G}"):
        tenvy.pd_segment(*ops(G, 3), seg=1)
    with pytest.raises(ValueError, match=f"k <= {tenvy.MAX_K}"):
        tenvy.pd_segment(*ops(8, tenvy.MAX_K + 1), seg=1)
    with pytest.raises(ValueError, match="seg"):
        tenvy.pd_segment(*ops(8, 3), seg=0)
    with pytest.raises(ValueError, match=r"Wp must be \(B, G, k\)"):
        tenvy.pd_segment(*(o[0] for o in ops(8, 3)), seg=1)


# ---------------------------------------------------------------------------
# the water-filling solve
# ---------------------------------------------------------------------------
def monge_instance(rng, n, k):
    """Same construction as tests/test_jax_solve.py."""
    a = np.cumsum(rng.uniform(0.05, 0.8, size=n)) + 1.0
    c = np.cumsum(rng.uniform(0.05, 0.6, size=k))
    c = c - c[0]
    return np.power(a[:, None], c[None, :]), rng.integers(1, 9, size=k).astype(float)


def solve_case(n, k, seed=0):
    _, Wf, m, mask = torch_solve._prepare(*monge_instance(np.random.default_rng(seed), n, k))
    return Wf, m, mask


@pytest.mark.parametrize("n", (1, 5, 8, 9, 16, 17, 40, 100, 300))
@pytest.mark.parametrize("k", (2, 3, 4))
def test_solve_matches_the_jax_solve_over_the_padding_buckets(n, k):
    """The wrapper (CPU tensors: the plain version) against the JAX tier's
    jitted solve on the same padded instance, cold and from a hint."""
    Wf, m, mask = solve_case(n, k, seed=n * 10 + k)
    kw = {"lanes": torch_solve.LANES, "iters": torch_solve.ITERS}
    for use_hint in (False, True):
        with x64():
            tau0, _ = jax_solve._solve_padded(Wf, m, mask, 0.0, use_hint=False)
            hint = float(tau0) * 0.97 if use_hint else -1.0
            tau_j, X_j = jax_solve._solve_padded(Wf, m, mask, hint, use_hint=use_hint)
        tau, X = twf.waterfill_solve(t64(Wf[None]), t64(m[None]), t64(mask[None]),
                                     t64([hint]), use_hint=use_hint, **kw)
        assert abs(float(tau[0]) - float(tau_j)) <= PARITY_TOL
        np.testing.assert_allclose(X[0].numpy(), np.asarray(X_j), atol=PARITY_TOL, rtol=0)


def test_cpu_solve_never_reaches_the_fused_wrapper_and_probes_through_torch_solve(
        monkeypatch):
    def unreachable(*_a, **_k):
        raise AssertionError("a CPU solve took the fused route")

    calls = []
    real = torch_solve.waterfill_masses

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(torch_solve, "waterfill_solve", unreachable)
    monkeypatch.setattr(torch_solve, "waterfill_masses", counting)
    Wf, m, mask = (t64(a[None]) for a in solve_case(12, 3))
    kw = {"lanes": torch_solve.LANES, "iters": torch_solve.ITERS, "use_hint": False}
    tau, X = torch_solve._solve_padded(Wf, m, mask, t64([-1.0]), **kw)
    assert len(calls) == torch_solve.ITERS
    ref_tau, ref_X = twf.waterfill_solve_plain(Wf, m, mask, t64([-1.0]), **kw)
    torch.testing.assert_close(tau, ref_tau, atol=0, rtol=0)
    torch.testing.assert_close(X, ref_X, atol=0, rtol=0)


def test_solve_of_a_batch_equals_its_instances():
    cases = [solve_case(30, 3, seed=s) for s in range(3)]
    Wf, m, mask = (t64(np.stack([c[i] for c in cases])) for i in range(3))
    kw = {"lanes": torch_solve.LANES, "iters": torch_solve.ITERS, "use_hint": False}
    taus, Xs = twf.waterfill_solve(Wf, m, mask, t64([-1.0] * 3), **kw)
    for b in range(3):
        tau, X = twf.waterfill_solve(Wf[b:b + 1], m[b:b + 1], mask[b:b + 1],
                                     t64([-1.0]), **kw)
        torch.testing.assert_close(taus[b:b + 1], tau, atol=0, rtol=0)
        torch.testing.assert_close(Xs[b:b + 1], X, atol=0, rtol=0)


def test_cpu_solve_counts_no_launch():
    Wf, m, mask = (t64(a[None]) for a in solve_case(12, 3))
    before = (twf.waterfill_solve.launches, twf.waterfill_masses.launches)
    twf.waterfill_solve(Wf, m, mask, t64([0.5]), lanes=8, iters=3, use_hint=True)
    assert (twf.waterfill_solve.launches, twf.waterfill_masses.launches) == before


SOLVE_NAMES = ("Wf", "m", "mask", "tau_hint")


@pytest.mark.parametrize("bad", ("dtype", "shape", "contiguous", "device"))
@pytest.mark.parametrize("which", range(4))
def test_solve_wrapper_rejects_a_malformed_operand_naming_it(bad, which):
    cases = [solve_case(12, 3, seed=s) for s in range(2)]
    ops = [t64(np.stack([c[i] for c in cases])) for i in range(3)] + [t64([-1.0, -1.0])]
    t = ops[which]
    if bad == "dtype":
        ops[which] = t.float()
    elif bad == "shape":
        ops[which] = torch.cat([t, t], dim=-1)
    elif bad == "contiguous":
        ops[which] = torch.cat([t, t], dim=-1)[..., ::2]
    else:
        ops[which] = t.to("meta")
    with pytest.raises((TypeError, ValueError), match=SOLVE_NAMES[which]):
        twf.waterfill_solve(*ops, lanes=8, iters=2, use_hint=False)


def test_solve_wrapper_rejects_k_and_lanes_above_its_limits():
    """The fused solve takes any k >= 1 (no table in the kernel is sized by
    k) and 1..MAX_LANES lanes; a solve of more lanes is routed elsewhere."""
    ops = (torch.ones((1, 8, 0), dtype=torch.float64), torch.ones((1, 0), dtype=torch.float64),
           torch.ones((1, 8), dtype=torch.float64), t64([-1.0]))
    with pytest.raises(ValueError, match="k >= 1"):
        twf.waterfill_solve(*ops, lanes=8, iters=2, use_hint=False)
    ops = [t64(a[None]) for a in solve_case(12, 3)] + [t64([-1.0])]
    for lanes in (0, twf.MAX_LANES + 1):
        with pytest.raises(ValueError, match=f"lanes <= {twf.MAX_LANES}"):
            twf.waterfill_solve(*ops, lanes=lanes, iters=2, use_hint=False)
    with pytest.raises(ValueError, match="iters"):
        twf.waterfill_solve(*ops, lanes=8, iters=-1, use_hint=False)


@pytest.mark.parametrize("device,lanes,fused", (
    ("cuda", 1, True), ("cuda", 8, True), ("cuda", twf.MAX_LANES + 1, False),
    ("cuda", 16, False), ("cpu", 8, False), ("cpu", 16, False), ("cuda:0", 4, True)))
def test_solve_route_takes_the_fused_kernel_on_the_card_up_to_the_lane_limit(
        device, lanes, fused):
    assert twf.fused_solve(device, lanes) is fused
    assert twf.fused_solve(torch.device(device), lanes) is fused


def test_the_lane_limit_matches_the_kernel_source():
    import os

    from repro_torch.kernels import _build

    with open(os.path.join(_build.SRC_DIR, "waterfill.cu")) as f:
        src = f.read()
    assert f"constexpr int kLanes = {twf.MAX_LANES};" in src
    assert "kMaxK" not in src


def test_solve_of_many_device_types_matches_the_jax_solve():
    """k = 40, above the 32 types the kernel's first version held in a
    fixed table: the fused wrapper takes it (on CPU tensors the plain
    version) and agrees with the JAX tier's jitted solve."""
    Wf, m, mask = solve_case(24, 40, seed=7)
    kw = {"lanes": torch_solve.LANES, "iters": torch_solve.ITERS}
    with x64():
        tau_j, X_j = jax_solve._solve_padded(Wf, m, mask, 0.0, use_hint=False)
    tau, X = twf.waterfill_solve(t64(Wf[None]), t64(m[None]), t64(mask[None]),
                                 t64([-1.0]), use_hint=False, **kw)
    assert abs(float(tau[0]) - float(tau_j)) <= PARITY_TOL
    np.testing.assert_allclose(X[0].numpy(), np.asarray(X_j), atol=PARITY_TOL, rtol=0)


def test_solve_of_more_lanes_than_the_kernel_takes_runs_the_unfused_route(monkeypatch):
    """A solve of 12 lanes is the unfused composition: the tier never calls
    the fused wrapper (on the card it would refuse 12 lanes), probes ITERS
    times through ``torch_solve.waterfill_masses``, and still solves."""
    def unreachable(*_a, **_k):
        raise AssertionError("a 12-lane solve took the fused route")

    calls = []
    real = torch_solve.waterfill_masses

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(torch_solve, "waterfill_solve", unreachable)
    monkeypatch.setattr(torch_solve, "waterfill_masses", counting)
    W, m = monge_instance(np.random.default_rng(12), 20, 3)
    tau12, _ = torch_solve.solve_noncoop_fast_torch(W, m, lanes=12, device="cpu")
    assert calls == [(1, 12)] * torch_solve.ITERS
    monkeypatch.undo()
    tau8, _ = torch_solve.solve_noncoop_fast_torch(W, m, device="cpu")
    assert abs(tau12 - tau8) <= PARITY_TOL


# ---------------------------------------------------------------------------
# both: no backward on the card
# ---------------------------------------------------------------------------
def _unreachable_load():
    raise AssertionError("the guard must raise before the kernel is loaded")


@pytest.mark.parametrize("op", ("pd_segment", "waterfill_solve"))
def test_fused_launches_refuse_inputs_that_require_grad(op, monkeypatch):
    """The CUDA branch of each wrapper raises before it loads the kernel
    when grad is enabled and an input requires grad."""
    if op == "pd_segment":
        mod = tenvy
        _, _, ops = segment_case("catalog", 40)
        ops = [o.clone() for o in ops]
        ops[4].requires_grad_()

        def launch():
            return tenvy._launch_segment(ops, 5)
    else:
        mod = twf
        Wf, m, mask = (t64(a[None]) for a in solve_case(12, 3))
        m.requires_grad_()

        def launch():
            return twf._launch_solve(Wf, m, mask, t64([-1.0]), 8, 3, False)
    monkeypatch.setattr(mod, "load", _unreachable_load)
    with pytest.raises(RuntimeError, match="no backward"):
        launch()
    with torch.no_grad(), pytest.raises(AssertionError, match="before the kernel"):
        launch()
