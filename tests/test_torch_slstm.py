"""The sLSTM recurrence's op in the port vs the JAX package, on the CPU.

``repro_torch.kernels.slstm.slstm_scan`` runs the xLSTM scalar-memory
mixer's recurrence over a whole sequence: on the card one launch of the
CUDA kernel each way, on the CPU its plain version, the port's loop over
positions. Here, at small widths:

  - the plain forward is the loop the port ran before the op, bit for bit,
    with grad and without (the CPU forward did not move);
  - the plain backward (an explicit reverse loop) is torch's autograd of
    that loop, in float64 within 1e-10 of max |grad|;
  - the mixer's gradients of x, ``w_x``, ``r``, ``b`` and ``w_down``
    against ``jax.vjp`` of ``slstm_apply``, at the smoke width (H 2) and at
    H 4, within 1e-5 of each gradient's max (float32; the two frameworks'
    products sum in other orders), and the outputs within 1e-5;
  - S = 1 through the op, the mixer's decode, against ``slstm_decode``;
  - the ops' fake forms' shapes and dtypes, and their FLOP formula against
    the products the plain loops' ``bmm``s count;
  - one fake call an sLSTM layer when a smoke model's sLSTM blocks run on
    fake CUDA tensors (``FakeTensorMode`` makes them without a card), no
    launch;
  - the wrapper's host side against a stand-in for the kernels' library:
    the sync state kept a stream for eager launches and fresh for each
    launch captured into a CUDA graph, the scratch each launch asks for,
    and a refused shape raising ``KernelError`` with no launch counted;
  - the planted per-head gate layout of ``chip_smoke.py``'s phase 51 moves
    the output wherever a head's columns are not the whole gate, and the
    phase itself, rehearsed with the plain versions counted as launches.

The kernel is held against the plain version on the card by
``chip_smoke.py`` phase 51.
"""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jax_smoke
from repro.distributed.sharding import make_plan
from repro.models import layers as JL
from repro_torch.configs import get_smoke
from repro_torch.kernels import launch_counts
from repro_torch.kernels import slstm as sl
from repro_torch.models import Model
from repro_torch.models.layers import NEG_INF, SLSTM
from torch_threads import one_thread

one_thread()

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "xlstm-350m"
LAYER_TOL = 1e-5
F64_TOL = 1e-10
#: (B, S, d, H, a non-zero initial state)
CASES = [(2, 9, 16, 2, False), (3, 7, 32, 4, True), (1, 1, 8, 1, True), (4, 20, 64, 2, True)]


def old_loop(xwb, r, state):
    """The port's sLSTM loop before the op (``layers.SLSTM._cell`` over
    ``xwb.unbind(1)``), as it stood: every h and the final state."""
    hs = []
    for xt in xwb.unbind(1):
        h, c, n, m = state
        B, d = h.shape
        H = r.shape[0]
        rec = torch.bmm(h.reshape(B, H, d // H).transpose(0, 1), r)  # (H, B, 4hd)
        pre = xt + rec.transpose(0, 1).reshape(B, 4 * d)
        i_pre, f_pre, z_pre, o_pre = pre.split(d, dim=1)
        lfm = F.logsigmoid(f_pre) + m
        m_new = torch.maximum(lfm, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(lfm - m_new)
        z_g = torch.tanh(z_pre)
        o_g = torch.sigmoid(o_pre)
        c_new = f_g * c + i_g * z_g
        n_new = f_g * n + i_g
        h_new = o_g * c_new / torch.clamp_min(n_new, 1.0)
        state = (h_new, c_new, n_new, m_new)
        hs.append(h_new)
    return torch.stack(hs, dim=1), state


def operands(B, S, d, H, nonzero, dtype=torch.float32, seed=0):
    """xwb at the model's scale (the forget gate's bias 3), r, and the
    initial state: zeros with m = NEG_INF, or a non-zero one."""
    rng = np.random.default_rng(seed)
    hd = d // H
    xwb = rng.standard_normal((B, S, 4 * d)) * 0.6
    xwb[..., d:2 * d] += 3.0
    r = rng.standard_normal((H, hd, 4 * hd)) * 0.3
    if nonzero:
        state = [rng.standard_normal((B, d)) * 0.3, rng.standard_normal((B, d)),
                 rng.uniform(0.5, 3.5, (B, d)), rng.standard_normal((B, d))]
    else:
        state = [np.zeros((B, d))] * 3 + [np.full((B, d), NEG_INF)]
    return [torch.tensor(a, dtype=dtype) for a in (xwb, r, *state)]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,d,H,nonzero", CASES)
@pytest.mark.parametrize("grad", [False, True])
def test_plain_forward_is_the_old_loop_bit_for_bit(B, S, d, H, nonzero, grad):
    ops = operands(B, S, d, H, nonzero)
    want_hs, want_state = old_loop(ops[0], ops[1], tuple(ops[2:]))
    if grad:
        ops = [t.requires_grad_() for t in ops]
    hs, *state = sl.slstm_scan(*ops)
    assert torch.equal(hs.detach(), want_hs)
    for got, want in zip(state, want_state):
        assert got.shape == (B, d) and torch.equal(got.detach(), want)
    assert (hs.grad_fn is not None) == grad


@pytest.mark.parametrize("B,S,d,H,nonzero", CASES)
def test_plain_backward_is_autograd_of_the_loop_in_float64(B, S, d, H, nonzero):
    """Every input's gradient, the final state's cotangents included,
    through the op's autograd Function (the hand-written reverse loop and
    one ``bmm`` for ``dr``) against autograd of the old loop."""
    ops = operands(B, S, d, H, nonzero, torch.float64, seed=1)
    rng = np.random.default_rng(2)
    g_hs = torch.tensor(rng.standard_normal((B, S, d)))
    g_state = [torch.tensor(rng.standard_normal((B, d))) for _ in range(4)]

    def loss(hs, state):
        return (hs * g_hs).sum() + sum((s * g).sum() for s, g in zip(state, g_state))

    xs = [t.clone().requires_grad_() for t in ops]
    hs, state = old_loop(xs[0], xs[1], tuple(xs[2:]))
    want = torch.autograd.grad(loss(hs, state), xs)
    ys = [t.clone().requires_grad_() for t in ops]
    hs, *state = sl.slstm_scan(*ys)
    got = torch.autograd.grad(loss(hs, state), ys)
    for name, a, b in zip(("xwb", "r", "h0", "c0", "n0", "m0"), got, want):
        assert a.dtype == torch.float64
        assert float((a - b).abs().max()) <= F64_TOL * max(1.0, float(b.abs().max())), name


def test_backward_plain_splits_a_maximum_tie_and_passes_clamp_at_one():
    """A step where ``lfm == i`` exactly and ``n == 1`` exactly (the first
    step from a zero state with ``m = 0`` and log_sigmoid(f) = i - 0): the
    hand-written backward takes torch's rules there, as autograd does."""
    d = 4
    xwb = torch.zeros(1, 1, 4 * d, dtype=torch.float64)
    f = torch.tensor([0.5, -1.0, 2.0, 0.0], dtype=torch.float64)
    xwb[0, 0, d:2 * d] = f
    xwb[0, 0, :d] = F.logsigmoid(f)  # i = log_sigmoid(f) + m with m = 0
    xwb[0, 0, 2 * d:] = 0.3
    r = torch.zeros(1, d, 4 * d, dtype=torch.float64)
    state = [torch.zeros(1, d, dtype=torch.float64) for _ in range(4)]
    ops = [xwb, r, *state]
    xs = [t.clone().requires_grad_() for t in ops]
    hs, st = old_loop(xs[0], xs[1], tuple(xs[2:]))
    want = torch.autograd.grad(hs.sum() + st[1].sum() + st[2].sum(), xs)
    ys = [t.clone().requires_grad_() for t in ops]
    hs, *st = sl.slstm_scan(*ys)
    got = torch.autograd.grad(hs.sum() + st[1].sum() + st[2].sum(), ys)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# the mixer against JAX
# ---------------------------------------------------------------------------


def mixer_pair(heads: int):
    """The JAX sLSTM params of the smoke width in float32 with ``heads``
    heads (the bias drawn at random: JAX initialises it to constants) and
    the port's ``SLSTM`` holding them."""
    over = {"n_heads": heads, "n_kv_heads": heads, "dtype": "float32"}
    jcfg, cfg = jax_smoke(ARCH, **over), get_smoke(ARCH, **over)
    params = JL.slstm_init(jcfg, jax.random.PRNGKey(heads))
    rng = np.random.default_rng(heads)
    params["b"] = params["b"] + jnp.asarray(rng.standard_normal(params["b"].shape) * 0.5,
                                            jnp.float32)
    mixer = SLSTM(cfg, device="cpu", trainable=True)
    with torch.no_grad():
        for k in ("w_x", "r", "b", "w_down"):
            getattr(mixer, k).copy_(torch.from_numpy(np.array(params[k], np.float32)))
    plan = make_plan(None, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads)
    return jcfg, plan, params, mixer


@pytest.mark.parametrize("heads,S", [(2, 24), (4, 12)])
def test_mixer_gradients_match_jax_vjp(heads, S):
    jcfg, plan, params, mixer = mixer_pair(heads)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jy, vjp = jax.vjp(lambda p, xx: JL.slstm_apply(p, jcfg, plan, xx), params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    ty = mixer(tx)
    (ty * torch.from_numpy(gy)).sum().backward()
    assert rel(ty.detach().numpy(), jy) <= LAYER_TOL
    assert rel(tx.grad.numpy(), jgx) <= LAYER_TOL
    for k in ("w_x", "r", "b", "w_down"):
        assert rel(getattr(mixer, k).grad.numpy(), jgp[k]) <= LAYER_TOL, k


@pytest.mark.parametrize("heads", [2, 4])
def test_decode_through_the_op_matches_slstm_decode(heads):
    """Ten positions of ``slstm_apply`` for a state, then three decode
    steps: the port's ``decode`` (the op at S = 1) against
    ``slstm_decode``, and against the plain step ``_cell`` bit for bit."""
    jcfg, plan, params, mixer = mixer_pair(heads)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 10, jcfg.d_model)).astype(np.float32)
    _, js = JL.slstm_apply(params, jcfg, plan, jnp.asarray(x), return_state=True)
    with torch.no_grad():
        _, ts = mixer(torch.from_numpy(x), return_state=True)
        for step in range(3):
            xs = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
            jy, js = JL.slstm_decode(params, jcfg, plan, jnp.asarray(xs), js)
            xwb = (torch.from_numpy(xs)[:, 0] @ mixer.w_x).float() + mixer.b
            cell = mixer._cell(xwb, tuple(ts[k] for k in "hcnm"))
            ty, ts = mixer.decode(torch.from_numpy(xs), ts, 10 + step)
            assert ty.shape == (3, 1, jcfg.d_model) and rel(ty.numpy(), jy) <= LAYER_TOL
            for k, c in zip("hcnm", cell):
                assert torch.equal(ts[k], c), (step, k)
                assert rel(ts[k].numpy(), js[k]) <= LAYER_TOL, (step, k)


# ---------------------------------------------------------------------------
# the ops: fake forms, FLOPs, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("save", [False, True])
def test_the_fake_forms(save):
    """Both ops' fake forms give the plain versions' shapes and dtypes,
    launch nothing and are counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = operands(2, 6, 16, 2, True)
    want = sl.slstm_scan_plain(*ops, save)
    hs, cs, ns, ms, pre = sl.slstm_scan_plain(*ops, True)
    bargs = (ops[1], pre, cs, ns, ms, *ops[3:], hs, *ops[3:])
    bwant = sl.slstm_scan_backward_plain(*bargs)
    launches = launch_counts()
    fwd, bwd = sl.slstm_scan.fake_calls, sl.slstm_scan_backward.fake_calls
    with FakeTensorMode() as mode:
        got = torch.ops.repro_torch.slstm_scan(*(mode.from_tensor(t) for t in ops), save)
        bgot = torch.ops.repro_torch.slstm_scan_backward(*(mode.from_tensor(t) for t in bargs))
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    assert [(t.shape, t.dtype) for t in bgot] == [(t.shape, t.dtype) for t in bwant]
    assert sl.slstm_scan.fake_calls == fwd + 1
    assert sl.slstm_scan_backward.fake_calls == bwd + 1
    assert launch_counts() == launches


def test_the_flop_formulas_count_the_plain_loops_products():
    """``FlopCounterMode`` on the plain forward and backward (their
    per-step ``bmm``s) counts what the ops' formulas give, 8 B S d hd each."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, S, d, H = 3, 5, 32, 4
    ops = operands(B, S, d, H, True)
    hs, cs, ns, ms, pre = sl.slstm_scan_plain(*ops, True)
    bargs = (ops[1], pre, cs, ns, ms, *ops[3:], hs, *ops[3:])
    want = sl.products(B, S, d, d // H)
    assert want == 8 * B * S * d * (d // H)
    for fn, args in ((sl.slstm_scan_plain, ops), (sl.slstm_scan_backward_plain, bargs)):
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        assert counter.get_total_flops() == want
    with FakeTensorMode() as mode, FlopCounterMode(display=False) as counter:
        torch.ops.repro_torch.slstm_scan(*(mode.from_tensor(t) for t in ops), False)
        torch.ops.repro_torch.slstm_scan_backward(*(mode.from_tensor(t) for t in bargs))
    assert counter.get_total_flops() == 2 * want


def test_one_fake_call_an_slstm_layer_on_fake_cuda_tensors():
    """A smoke model's sLSTM blocks on fake CUDA tensors take the card's
    path: one call of the scan's fake form a block and a decode step, no
    launch, outputs and state of the right shapes and devices. (The mLSTM's
    chunk loop indexes with a tensor, which a CPU-only torch cannot do on a
    fake CUDA tensor, so the blocks run alone.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_smoke(ARCH)
    launches, calls = launch_counts(), sl.slstm_scan.fake_calls
    with FakeTensorMode():
        model = Model(cfg, device="cuda")
        blocks = [b for b, kind in zip(model.layers, model.kinds) if kind == "slstm"]
        x = torch.zeros((2, 16, cfg.d_model), dtype=torch.bfloat16, device="cuda")
        for block in blocks:
            x = block(x)
        y, state = blocks[0].mixer(x, return_state=True)
        out, state = blocks[0].mixer.decode(x.narrow(1, 0, 1), state, 16)
    assert len(blocks) == 2
    assert sl.slstm_scan.fake_calls == calls + len(blocks) + 2
    assert launch_counts() == launches
    assert x.device.type == "cuda" and tuple(out.shape) == (2, 1, cfg.d_model)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        k: ((2, cfg.d_model), torch.float32) for k in "hcnm"}


def test_refusals():
    from torch._subclasses.fake_tensor import FakeTensorMode

    xwb, r, *state = operands(2, 3, 16, 2, True)
    with pytest.raises(ValueError, match="does not fit"):
        sl.slstm_scan(xwb, r[:, :, :-1], *state)
    with pytest.raises(ValueError, match="h0 has shape"):
        sl.slstm_scan(xwb, r, state[0][:1], *state[1:])
    with pytest.raises(ValueError, match="float32"):
        sl.slstm_scan(xwb.double(), r, *state)
    with FakeTensorMode():  # the kernel takes float32 alone
        cuda = [torch.empty(t.shape, dtype=torch.float64, device="cuda")
                for t in (xwb, r, *state)]
        with pytest.raises(ValueError, match="float32"):
            sl.slstm_scan(*cuda)


class FakeLib:
    """The kernels' library as the wrapper sees it, on the CPU: the sizes
    of the exchange buffer and the sync state, a plan query that answers
    ``plan``, and launches that record what they were given and return
    ``code``."""

    #: ``csrc/slstm.cu``'s kNotResident and kMalformed
    NOT_RESIDENT, MALFORMED = 10001, 10003

    def __init__(self, code=0, plan=(0, 1, 0, 1, 128, 2, 1, 2048, 1, 16, 215040, 0)):
        self.code, self.plan, self.launches, self.sizes, self.plans = code, plan, [], [], []

    def slstm_sync_words(self):
        return 16 * (1 + 256)

    def slstm_exchange_floats(self, d, H, backward):
        self.sizes.append((d, H, backward))
        return 3 * (-(-d // 8)) * 64 * (4 if backward else 1)

    def slstm_plan(self, d, H, nsm, backward, out):
        self.plans.append((d, H, nsm, backward))
        import ctypes

        ctypes.memmove(out, (ctypes.c_longlong * len(self.plan))(*self.plan),
                       8 * len(self.plan))
        return self.plan[0]

    def slstm_forward(self, *args):
        self.launches.append(("forward", args))
        return self.code

    def slstm_backward(self, *args):
        self.launches.append(("backward", args))
        return self.code

    def slstm_error_string(self, code):
        return {self.NOT_RESIDENT: b"the card cannot hold every block of this launch at once",
                self.MALFORMED: b"the shape is malformed: d must be a positive multiple "
                                b"of H"}[code]


@pytest.fixture
def fake_card(monkeypatch):
    """Run the wrapper's launches on CPU tensors against a :class:`FakeLib`:
    no device context, stream 7, no capture unless a test says so."""
    import contextlib
    import types

    monkeypatch.setattr(sl, "_SYNC", {})
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    def use(lib):
        monkeypatch.setattr(sl, "_LIB", lib)
        return lib
    return use


def test_the_sync_state_is_zeroed_once_and_kept_per_device_and_stream(fake_card):
    """The kernels' sync state (the launch epoch and one flag a block):
    the library's count of int64 words, zeroed at the first eager launch on
    a (device, stream) and then the same tensor, so the epoch the kernel
    advances in place carries to the next launch and no launch fills a
    counter of its own; another stream gets its own."""
    lib = fake_card(FakeLib())
    cpu = torch.device("cpu")
    state = sl._sync_state(lib, cpu, 7)
    assert state.dtype == torch.int64 and tuple(state.shape) == (lib.slstm_sync_words(),)
    assert not state.any()
    state[0] = 4099  # a launch's end: the epoch advanced past its flags
    assert sl._sync_state(lib, cpu, 7) is state and int(state[0]) == 4099
    other = sl._sync_state(lib, cpu, 8)
    assert other is not state and not other.any()


def test_a_captured_launch_gets_a_zeroed_sync_state_of_its_own(fake_card, monkeypatch):
    """A launch captured into a CUDA graph takes a fresh zeroed state (in
    the graph's pool on the card), not the stream's, and keeps none: two
    graphs replayed at once on two streams share no epoch."""
    lib = fake_card(FakeLib())
    cpu = torch.device("cpu")
    eager = sl._sync_state(lib, cpu, 7)
    eager[0] = 12
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    a, b = sl._sync_state(lib, cpu, 7), sl._sync_state(lib, cpu, 7)
    assert a is not b and a is not eager and not a.any() and not b.any()
    assert a.dtype == torch.int64 and a.numel() == lib.slstm_sync_words()
    assert list(sl._SYNC.values()) == [eager] and int(eager[0]) == 12


@pytest.mark.parametrize("backward", [False, True])
def test_a_launch_passes_its_scratch_and_the_streams_sync_state(fake_card, backward):
    """Each launch asks the library for its exchange buffer's size (the
    backward's holds the four gates), passes the stream's sync state, and
    counts one launch; two launches on one stream share that state."""
    lib = fake_card(FakeLib())
    B, S, d, H = 3, 5, 24, 3
    xwb, r, *state = operands(B, S, d, H, True)
    before = (sl.slstm_scan.launches, sl.slstm_scan_backward.launches)
    for _ in range(2):
        if backward:
            _, cs, ns, ms, pre = sl.slstm_scan_plain(xwb, r, *state, True)
            dhs = torch.ones((B, S, d))
            sl._launch_backward(r, pre, cs, ns, ms, *state[1:], dhs, *state[1:])
        else:
            sl._launch(xwb, r, *state, False)
    assert lib.sizes == [(d, H, int(backward))] * 2
    sync = sl._SYNC[(str(torch.device("cpu")), 7)]
    for way, args in lib.launches:
        assert way == ("backward" if backward else "forward")
        # the pointers, then B, S, d, H (and save), then the stream
        assert args[-1] == 7 and sync.data_ptr() in args
        tail = args[-5:-1] if backward else args[-6:-1]
        assert tail == ((B, S, d, H) if backward else (B, S, d, H, 0))
    counts = (sl.slstm_scan.launches - before[0], sl.slstm_scan_backward.launches - before[1])
    assert counts == ((0, 2) if backward else (2, 0))


@pytest.mark.parametrize("code,match", [
    (FakeLib.MALFORMED, "d must be a positive multiple of H"),
    (FakeLib.NOT_RESIDENT, "cannot hold every block")])
@pytest.mark.parametrize("backward", [False, True])
def test_a_refused_launch_raises_and_counts_nothing(fake_card, code, match, backward):
    """Where the library refuses a launch (a malformed shape, d not a
    multiple of H: kMalformed, which ``_check_operands`` refuses first; a
    grid the card cannot hold at once: kNotResident, a guard no width
    reaches on an H100), the wrapper raises ``KernelError`` with the
    library's reason and counts no launch: nothing falls back to the plain
    version. No width is refused: the library has no such reason."""
    fake_card(FakeLib(code))
    B, S, d, H = 2, 3, 16, 2
    xwb, r, *state = operands(B, S, d, H, True)
    before = (sl.slstm_scan.launches, sl.slstm_scan_backward.launches)
    with pytest.raises(sl.KernelError, match=match):
        if backward:
            _, cs, ns, ms, pre = sl.slstm_scan_plain(xwb, r, *state, True)
            sl._launch_backward(r, pre, cs, ns, ms, *state[1:], torch.ones((B, S, d)),
                                *state[1:])
        else:
            sl._launch(xwb, r, *state, True)
    assert (sl.slstm_scan.launches, sl.slstm_scan_backward.launches) == before


@pytest.mark.parametrize("backward", [False, True])
def test_the_plan_query_reads_the_librarys_plan(fake_card, backward):
    """``slstm_plan`` asks the library for a shape's plan without launching
    and names its fields: the wide route at 1.3B's width (128 blocks of 2
    groups on 132 SMs, the staged tile whole, r's 16 jobs in shared memory),
    then a refusal with the library's reason."""
    lib = fake_card(FakeLib())
    launches = launch_counts()
    plan = sl.slstm_plan(2048, 4, 132, backward)
    assert lib.plans == [(2048, 4, 132, int(backward))] and not lib.launches
    assert plan == {"code": 0, "route": "wide", "registers": 0, "blocks_an_sm": 1,
                    "grid": 128, "groups_a_block": 2, "span": 1, "chunk": 2048, "chunks": 1,
                    "r_jobs_in_shared": 16, "smem_bytes": 215040, "scratch_floats": 0,
                    "refused": None}
    lib.plan = (FakeLib.MALFORMED,) + (0,) * 11
    assert sl.slstm_plan(2048, 3, 132, backward)["refused"].startswith("the shape is malformed")
    assert launch_counts() == launches


def test_the_phase_51_sweep_asks_every_width_and_fails_on_a_refusal(monkeypatch):
    """Phase 51's plan sweep asks the plan of every d up to its limit that
    each head count divides, both ways, on each SM count, and fails the
    phase on any refusal."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    asked = []

    def plan(d, H, nsm, backward=False, refuse=()):
        asked.append((d, H, nsm, backward))
        wide = d // H > 256 or -(-d // 8) > 2 * nsm
        return {"route": "wide" if wide else "narrow", "chunks": 1, "smem_bytes": 1,
                "refused": "no" if (d, H) in refuse else None}

    monkeypatch.setattr(sl, "slstm_plan", plan)
    out = cs.slstm_plan_sweep(sl, (132, 114), d_max=2400, heads=(2, 8))
    assert len(asked) == 2 * 2 * (1200 + 300)
    assert out["132"]["refused"] == [] and sum(out["132"]["routes"].values()) == 3000
    assert out["114"]["routes"]["wide"] > out["132"]["routes"]["wide"] > 0
    monkeypatch.setattr(sl, "slstm_plan", lambda d, H, nsm, backward=False:
                        plan(d, H, nsm, backward, refuse={(520, 2)}))
    with pytest.raises(cs.SmokeFailure, match="refuses"):
        cs.slstm_plan_sweep(sl, (132,), d_max=600, heads=(2, 8))


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 51
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,H", [(1024, 4), (64, 2), (16, 1)])
def test_the_planted_per_head_layout_moves_every_h_unless_one_head(d, H):
    """The planted fault of phase 51 at xlstm-350m's width and the smoke
    width: each head's columns split into its own gates; with one head the
    two layouts coincide, so the fault is the layout and nothing else."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    ops = operands(2, 4, d, H, True)
    ops[1] = ops[1] * (0.02 / 0.3)  # r at the model's init scale
    got = cs.planted_per_head_scan(torch, *ops)
    want = sl.slstm_scan_plain(*ops)[0]
    if H == 1:
        assert torch.equal(got, want)
    else:
        assert rel(got.numpy(), want.numpy()) > cs.SLSTM_FWD_TOL


def test_phase_51_reaches_the_kernels_instances_for_two_blocks_an_sm(monkeypatch):
    """Phase 51 holds the kernels to their plain versions on both routes:
    the narrow one at xlstm-350m's width (128 groups of 8 features: one
    block an SM on a 132-SM H100) and at a width of more groups than that
    card's SMs (the instances compiled for two blocks an SM); the wide one
    at heads wider than 256 (the xLSTM paper's 760M, 1.3B and 2.7B widths)
    and at more groups than two blocks an SM hold (2 x 132), with a decode
    step among them; its timed wide shape is 1.3B's at prefill length."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    groups = {label: -(-d // 8) for label, _, _, d, _, _ in cs.SLSTM_CASES}
    hd = {label: d // H for label, _, _, d, H, _ in cs.SLSTM_CASES}
    assert groups["prefill"] == 128 <= 132 < groups["wide"] <= 256 and hd["wide"] <= 256
    narrow = {k for k in groups if hd[k] <= 256 and groups[k] <= 2 * 132}
    assert {"prefill", "smoke", "decode", "ragged", "wide"} == narrow
    assert {k for k in hd if hd[k] > 256} == {"xl760m", "xl1b3", "xl2b7", "ragged_wide",
                                              "decode_wide"}
    assert {k for k in groups if groups[k] > 2 * 132} == {"xl2b7", "ragged_wide"}
    assert [(hd[k], groups[k]) for k in ("xl760m", "xl1b3", "xl2b7")] == [
        (384, 192), (512, 256), (640, 320)]
    assert any(S == 1 and hd[label] > 256 for label, _, S, _, _, _ in cs.SLSTM_CASES)
    assert [c[1:] for c in cs.SLSTM_WIDE_TIMED] == [(8, 2048, 2048, 4, False)]
    assert cs.SLSTM_SWEEP_D >= 8192 and set(cs.SLSTM_SWEEP_HEADS) >= {1, 2, 4, 8}
    assert set(cs.SLSTM_SWEEP_SMS) >= {114, 132}


def test_chip_smoke_phase_51_rehearses_on_the_cpu(monkeypatch):
    """Phase 51 on the CPU at cut shapes: the plain versions stand in for
    the kernels and count as their launches, the timers are stubbed. Its
    checks must pass: kernel (here plain) against plain, a second launch
    identical, grad through the op against autograd of the loop, the
    planted layout failing."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    fwd, bwd = sl.slstm_scan_plain, sl.slstm_scan_backward_plain

    def launch(*args):
        sl.slstm_scan.launches += 1
        return fwd(*args)

    def launch_backward(*args):
        sl.slstm_scan_backward.launches += 1
        return bwd(*args)

    monkeypatch.setattr(sl, "_launch", launch)
    monkeypatch.setattr(sl, "_launch_backward", launch_backward)
    for name in ("graph_ms", "call_ms"):
        monkeypatch.setattr(cs, name, lambda torch, fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "once_ms", lambda torch, fn: (fn(), 1.0)[1])
    monkeypatch.setattr(sl, "slstm_plan", lambda d, H, nsm, backward=False: {
        "route": "wide" if d // H > 8 else "narrow", "registers": 1, "blocks_an_sm": 1,
        "grid": 4, "groups_a_block": 1, "chunks": 1, "r_jobs_in_shared": 4, "smem_bytes": 1,
        "refused": None})
    # the new wide cases cut: heads over the stand-in plan's 8, a ragged one
    # of two passes, a decode step
    cases = (("prefill", 2, 40, 64, 2, False), ("smoke", 2, 12, 16, 2, False),
             ("decode", 3, 1, 32, 4, True), ("ragged", 3, 9, 20, 4, True),
             ("xl1b3", 2, 6, 48, 4, True), ("ragged_wide", 11, 3, 36, 2, True),
             ("decode_wide", 2, 1, 48, 4, True))
    before = (sl.slstm_scan.launches, sl.slstm_scan_backward.launches)
    detail = {}
    out = cs.slstm_phase(torch, sl, detail, dev="cpu", cases=cases,
                         wide_timed=(("xl1b3_prefill", 2, 24, 48, 4, False),), sweep_d=64)
    assert detail["slstm_kernel"] is out and set(out["cases"]) == {c[0] for c in cases}
    assert set(out["plan_sweep"]) == {"132", "114"}
    assert all(not v["refused"] for v in out["plan_sweep"].values())
    assert {label: rec["route"]["forward"]["route"] for label, rec in out["cases"].items()} == {
        c[0]: "wide" if c[3] // c[4] > 8 else "narrow" for c in cases}
    for rec in out["cases"].values():
        assert rec["forward"]["worst"] == 0.0 and rec["backward"]["worst"] == 0.0
        assert rec["forward"]["tol"] == cs.SLSTM_FWD_TOL
        assert rec["planted_per_head_rel_err"] > cs.SLSTM_FWD_TOL
        assert max(rec["backward"]["grad_rel_err"].values()) <= cs.SLSTM_BWD_TOL
    # two launches a way a case, then the timed calls
    assert sl.slstm_scan.launches - before[0] >= 4 * len(cases)
    assert sl.slstm_scan_backward.launches - before[1] >= 2 * len(cases)
    assert out["shape"] == [2, 40, 64, 2] and out["library_ms"] is None
    assert out["bound_by"] == "operations" or out["bound_by"] == "bytes"
    # the timed cases, each with its time a step of the scan; the first's are the
    # phase's; the wide route's with no plain loop
    assert list(out["times"]) == [*cs.SLSTM_TIMED, "xl1b3_prefill"]
    assert list(cs.SLSTM_TIMED) == ["prefill", "smoke"]
    for label, S in (("prefill", 40), ("smoke", 12), ("xl1b3_prefill", 24)):
        t = out["times"][label]
        assert t["shape"][1] == S
        for way in ("forward", "forward_saving", "backward"):
            assert t[way]["kernel_ms"] == 1.0 and t[way]["bound_ms"] > 0
            assert t[way]["us_per_step"] == pytest.approx(1e3 / S)
        assert (t["backward"]["plain_ms"] is None) == (label == "xl1b3_prefill")
    assert out["times"]["xl1b3_prefill"]["route"] == "wide"
    assert out["kernel_ms"] == out["forward"]["kernel_ms"] and out["plain_ms"] == 1.0
    for way in ("forward", "forward_saving", "backward"):
        assert out[way] is out["times"]["prefill"][way]
