"""The RG-LRU scan's backward in the port vs the JAX package, on the CPU.

``repro_torch.kernels.rglru_scan`` differentiates the scan through an
autograd Function whose backward is the reverse scan
(``rglru_scan_backward``: the CUDA kernel on the card, its plain version on
CPU tensors). Here the plain version is held to:

  - torch autograd of the plain forward ``rglru_scan_plain``, at atol 1e-5 /
    rtol 1e-4 (the same recurrence differentiated by autograd's own chain
    of multiplies and adds, in another association, float32);
  - ``jax.vjp`` of ``repro.models.layers.rglru_scan_ref``, the associative
    scan the JAX model differentiates, at atol 1e-5 / rtol 1e-4, the
    tolerance of the JAX package's kernel test, over that test's shape
    range, S = 1, a ragged D and a nonzero ``h0``;
  - and the port's ``RGLRU`` layer's gradients against ``jax.grad`` of
    ``rglru_apply`` with the same weights, within 1e-5 of each gradient's
    max |g| (float32; the two frameworks' products sum in other orders).

The kernel itself is held against the plain version on the card by
``chip_smoke.py``; here the card's branch is driven with the launches
replaced by the plain versions, to show it takes the Function.
"""
import traceback

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jax_smoke
from repro.distributed.sharding import make_plan
from repro.models import init_params as jax_init
from repro.models import layers as JL
from repro_torch.configs import get_smoke
from repro_torch.interop import model_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from torch_threads import one_thread

one_thread()

ATOL, RTOL = 1e-5, 1e-4
LAYER_TOL = 1e-5
ARCH = "recurrentgemma-2b"
SHAPES = [(1, 64, 32), (2, 128, 64), (3, 192, 128), (2, 256, 256), (3, 64, 256),
          (2, 64, 96), (1, 128, 40), (2, 1, 64), (1, 1, 1), (1, 17, 8)]


def operands(B, S, D, seed):
    """As the JAX property test draws them: a = sigmoid(N), b = N, h0 = N;
    and an incoming gradient dh = N."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D))))
    b, h0, dh = (rng.standard_normal(s) for s in ((B, S, D), (B, D), (B, S, D)))
    return tuple(x.astype(np.float32) for x in (a, b, h0, dh))


@jax.jit
def _vjp(a, b, h0, dh):
    return jax.vjp(JL.rglru_scan_ref, a, b, h0)[1](dh)


def jax_vjp(a, b, h0, dh):
    return tuple(np.asarray(g) for g in _vjp(*(jnp.asarray(x) for x in (a, b, h0, dh))))


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_backward_plain_matches_jax_vjp_of_the_associative_scan(B, S, D):
    a, b, h0, dh = operands(B, S, D, seed=B * 100 + S + D)
    h = rg.rglru_scan_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    got = rg.rglru_scan_backward_plain(torch.from_numpy(a), h, torch.from_numpy(h0),
                                       torch.from_numpy(dh))
    for name, g, w in zip(("da", "db", "dh0"), got, jax_vjp(a, b, h0, dh)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_backward_plain_matches_autograd_of_the_plain_forward(B, S, D):
    a, b, h0, dh = (torch.from_numpy(x) for x in operands(B, S, D, seed=S + 7 * D))
    leaves = [x.clone().requires_grad_() for x in (a, b, h0)]
    rg.rglru_scan_plain(*leaves).backward(dh)
    h = rg.rglru_scan_plain(a, b, h0)
    got = rg.rglru_scan_backward_plain(a, h, h0, dh)
    for name, g, x in zip(("da", "db", "dh0"), got, leaves):
        torch.testing.assert_close(g, x.grad, atol=ATOL, rtol=RTOL, msg=name)


@pytest.mark.parametrize("B,S,D", [(2, 64, 32), (1, 1, 8), (3, 40, 96)])
def test_grad_through_the_op_is_the_backward_plain_version(B, S, D):
    """``ops.rglru_scan`` on CPU tensors that require grad: autograd's
    gradients are exactly the plain backward's, for a, b and h0."""
    a, b, h0, dh = (torch.from_numpy(x) for x in operands(B, S, D, seed=5))
    leaves = [x.clone().requires_grad_() for x in (a, b, h0)]
    out = ops.rglru_scan(*leaves)
    assert isinstance(out.grad_fn, rg.RGLRUScan._backward_cls)
    assert torch.equal(out.detach(), rg.rglru_scan_plain(a, b, h0))
    out.backward(dh)
    want = rg.rglru_scan_backward_plain(a, out.detach(), h0, dh)
    for name, x, w in zip(("a", "b", "h0"), leaves, want):
        assert torch.equal(x.grad, w), name


def test_no_grad_wanted_takes_no_function():
    a, b, h0, _ = (torch.from_numpy(x) for x in operands(1, 8, 16, seed=1))
    assert ops.rglru_scan(a, b, h0).grad_fn is None
    with torch.no_grad():
        assert ops.rglru_scan(a.requires_grad_(), b, h0).grad_fn is None


def test_bf16_input_that_requires_grad_raises():
    a, b, h0, _ = (torch.from_numpy(x) for x in operands(1, 8, 16, seed=2))
    with pytest.raises(RuntimeError, match="float32 only.*float32 state"):
        ops.rglru_scan(a.bfloat16().requires_grad_(), b.bfloat16(), h0)


def test_card_branch_goes_through_the_function(monkeypatch):
    """The card's branch (``_scan(..., on_card=True)``) with both launches
    replaced by their plain versions: the forward and the backward each
    launch once, and the gradients are the plain ones."""
    calls = []

    def fwd(a, b, h0):
        calls.append("forward")
        return rg.rglru_scan_plain(a, b, h0)

    def bwd(a, h, h0, dh):
        calls.append("backward")
        return rg.rglru_scan_backward_plain(a, h, h0, dh)

    monkeypatch.setattr(rg, "_launch", fwd)
    monkeypatch.setattr(rg, "_launch_backward", bwd)
    a, b, h0, dh = (torch.from_numpy(x) for x in operands(2, 33, 24, seed=3))
    # the CPU stands in for the card, so the backward wrapper's device
    # dispatch is pointed at the launch too
    monkeypatch.setattr(rg, "rglru_scan_backward", lambda *t: rg._launch_backward(*t))
    leaves = [x.clone().requires_grad_() for x in (a, b)]
    out = rg._scan(*leaves, h0, True)
    out.backward(dh)
    assert calls == ["forward", "backward"]
    want = rg.rglru_scan_backward_plain(a, rg.rglru_scan_plain(a, b, h0), h0, dh)
    assert torch.equal(leaves[0].grad, want[0]) and torch.equal(leaves[1].grad, want[1])


def _unreachable_load():
    raise AssertionError("the kernel is loaded here")


def test_card_branch_reaches_the_kernel_through_the_function(monkeypatch):
    """With grad, the card's branch loads the kernel inside the Function's
    forward (no refusal); without grad, outside it."""
    monkeypatch.setattr(rg, "load", _unreachable_load)
    a, b, h0, _ = (torch.from_numpy(x) for x in operands(1, 8, 16, seed=4))

    def frames(call):
        with pytest.raises(AssertionError, match="kernel is loaded") as info:
            call()
        return [f.name for f in traceback.extract_tb(info.tb)]

    with_grad = frames(lambda: rg._scan(a.clone().requires_grad_(), b, h0, True))
    assert "forward" in with_grad and with_grad[-2:] == ["_launch", "_unreachable_load"]
    without = frames(lambda: rg._scan(a, b, h0, True))
    assert "forward" not in without and without[-2:] == ["_launch", "_unreachable_load"]


def test_backward_checks_its_operands():
    a, b, h0, dh = (torch.from_numpy(x) for x in operands(1, 8, 16, seed=6))
    with pytest.raises(ValueError, match="dh has shape"):
        rg.rglru_scan_backward(a, a, h0, dh[:, :4])
    with pytest.raises(ValueError, match="float32"):
        rg.rglru_scan_backward(a, a, h0.double(), dh)


def test_launch_counters_start_at_zero_and_count_only_kernels():
    a, b, h0, dh = (torch.from_numpy(x) for x in operands(1, 8, 16, seed=8))
    before = (rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
    out = ops.rglru_scan(a.requires_grad_(), b, h0)
    out.backward(dh)
    assert (rg.rglru_scan.launches, rg.rglru_scan_backward.launches) == before


def test_rglru_layer_grads_match_jax_grad_of_rglru_apply():
    """The port's RGLRU layer (float32 masters) against ``jax.grad`` of
    ``rglru_apply`` (``use_pallas=False``, the associative scan), same
    weights and input, float32: the input's gradient and every weight's."""
    jcfg = jax_smoke(ARCH, dtype="float32")
    cfg = get_smoke(ARCH, dtype="float32")
    plan = make_plan(None, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    layer_p = jax.tree.map(lambda a: a[0], params["units"]["p0"]["mixer"])
    x = np.random.default_rng(9).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(10).standard_normal((2, 48, cfg.d_model)).astype(np.float32)

    def f(p, xx):
        return jnp.sum(JL.rglru_apply(p, jcfg, plan, xx) * w)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(layer_p, jnp.asarray(x))
    model = model_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    layer = model.layers[0].mixer
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(layer(xt) * torch.from_numpy(w)).backward()
    pairs = [("x", xt.grad, gx)] + [(n, getattr(layer, n).grad, gp[n]) for n in gp]
    for name, got, want in pairs:
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        assert err <= LAYER_TOL, (name, err)
