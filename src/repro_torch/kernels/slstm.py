"""The sLSTM recurrence: the CUDA kernels (forward and backward) and their
plain versions.

Every sLSTM layer of xlstm-350m runs, over positions t = 0..S-1 from the
state (h0, c0, n0, m0), the step of the xLSTM paper's stabilised
exponential gating (eq. 15-17):

    rec  = h @ r, per head (h's k-th hd-slice @ r[k], the H results of
           4 hd laid end to end), then split into [i | f | z | o] along 4d
    pre  = xwb_t + rec
    lfm  = log_sigmoid(f) + m,   m' = max(lfm, i)
    c'   = exp(lfm - m') c + exp(i - m') tanh(z),   n' = exp(lfm - m') n + exp(i - m')
    h'   = sigmoid(o) c' / max(n', 1)

in float32: ``xwb`` (B, S, 4d) is ``x @ w_x`` plus the bias, ``r`` (H, hd,
4 hd), the state (B, d) each. The JAX model runs it as a ``jax.lax.scan``
(``src/repro/models/layers.py`` ``slstm_apply``, ``slstm_decode``), one loop
on the device; no Pallas kernel exists for it.

:func:`slstm_scan` returns ``(hs, hT, cT, nT, mT)``: every ``h_t`` (B, S,
d) and the final state. On a CUDA tensor it launches the hand-written
kernel of ``csrc/slstm.cu`` (built with ``nvcc`` on first use, see
:mod:`repro_torch.kernels._build`): the whole scan in one cooperative
launch. A step is one exchange between the SMs: each block stores its slice
of ``h_t`` into an exchange buffer that :func:`_launch` allocates
(uninitialised, three slots used in turn) and raises its flag in the sync
state (:func:`_sync_state`: it holds the launch epoch, so no flag of an
earlier launch can pass for a current one); the other blocks poll the
flags and load the slices they need. Every (d, H) with H dividing d runs;
:func:`slstm_plan` says how, without launching. Two routes:

  - narrow (a head of at most 256, at most twice the SMs in groups of 8
    features): one block for each 8 features (one an SM at xlstm-350m's
    width, two an SM past the SMs), its share of ``r`` in registers, what
    a step reads that does not depend on the step before on its way ahead
    of it, the state in registers. What bounds it on an NVIDIA H100 80GB
    HBM3 at 700.00 W, at xlstm-350m's prefill shape (8, 2048, d 1024, H 4):
    the recurrent products, 0.51 ms at the FP32 rate each way, and below
    them the chain of 2,048 exchanges, 1.76 us a step and 3.61 ms when
    timed alone (a probe of the kernels' variants, PERF.md); the kernels
    take 6.2 ms forward and 6.9 ms backward, ~3.0 and ~3.4 us a step;
  - wide (every other shape: the xLSTM paper's 760M, 1.3B and 2.7B widths,
    hd 384 / 512 / 640, or more groups than two blocks an SM hold): one
    block an SM owning ceil(groups / SMs) groups; ``r``'s share in shared
    memory as far as it fits beside the staged tile, the rest read from
    device memory (the forward's columns from a transposed copy each block
    writes after the exchange buffer, so :func:`_launch` allocates both);
    the staged tile in chunks where it does not fit whole; the carried
    state through the state outputs. PERF.md has its times.

Nothing is refused for its width: only a malformed shape (d not a multiple
of H, which :func:`_check_operands` refuses first) and, as a guard no width
reaches on an H100, a grid the card cannot hold at once raise
``KernelError``. On a CPU tensor it runs :func:`slstm_scan_plain`, the
port's loop over positions of :func:`slstm_cell`. A CUDA tensor never falls
back to the plain version: a failed build or a refused launch raises.

When grad is enabled and an input requires grad, the call goes through
:class:`SLSTMScan`, whose forward also keeps the state after every step
and the pre-activations, and whose backward is :func:`slstm_scan_backward`
(the kernel on the card, :func:`slstm_scan_backward_plain`, an explicit
reverse loop, on the CPU), followed by one ``torch.bmm`` for ``dr``. The
backward follows PyTorch's autograd of the plain loop: ``clamp_min(n, 1)``
passes the gradient at ``n == 1`` (JAX's ``maximum`` passes half there,
which differs only in the initial ``n``'s gradient, since the first step's
input gate is exactly 1), and ``maximum`` splits a tie half and half.

Both launches are custom ops, ``torch.ops.repro_torch.slstm_scan`` and
``torch.ops.repro_torch.slstm_scan_backward`` (bodies :func:`_launch` and
:func:`_launch_backward`), whose fake forms give the outputs' shapes and
dtypes and launch nothing, so the dry-run traces the card's path on fake
CUDA tensors; their FLOP formulas count the recurrent products only,
``8 B S d hd`` each way. ``slstm_scan.launches`` and
``slstm_scan_backward.launches`` count the launches, ``.fake_calls`` the
fake-form calls.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._build import KernelError


def slstm_pre(xwb_t, r, h):
    """The step's pre-activations (B, 4d): ``xwb_t`` plus each head's
    ``h`` slice times ``r[k]``, the heads' 4 hd outputs laid end to end."""
    B, d = h.shape
    H = r.shape[0]
    rec = torch.bmm(h.reshape(B, H, d // H).transpose(0, 1), r)  # (H, B, 4hd)
    return xwb_t + rec.transpose(0, 1).reshape(B, 4 * d)


def slstm_gates(pre, c, n, m):
    """The gates and the state update from the pre-activations: (h, c, n,
    m) after the step."""
    i_pre, f_pre, z_pre, o_pre = pre.split(c.shape[1], dim=1)
    lfm = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(lfm - m_new)
    z_g = torch.tanh(z_pre)
    o_g = torch.sigmoid(o_pre)
    c_new = f_g * c + i_g * z_g
    n_new = f_g * n + i_g
    h_new = o_g * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new, m_new


def slstm_cell(xwb_t, r, state):
    """One step. xwb_t: (B, 4d) float32 input pre-activation with the bias
    added; state: h, c, n, m (B, d). Returns the next state."""
    h, c, n, m = state
    return slstm_gates(slstm_pre(xwb_t, r, h), c, n, m)


def slstm_scan_plain(xwb, r, h0, c0, n0, m0, save: bool = False):
    """Plain torch version of the op: a loop over positions of
    :func:`slstm_cell`. Returns ``(hs, cs, ns, ms, pre)``: hs (B, S, d);
    with ``save`` the state after every step (B, S, d) and the
    pre-activations (B, S, 4d), else the final state (B, 1, d) and an empty
    (B, 0, 4d) ``pre``."""
    state = (h0, c0, n0, m0)
    hs, cs, ns, ms, pres = [], [], [], [], []
    # one unbind, not S slices
    for xt in xwb.unbind(1):
        pre = slstm_pre(xt, r, state[0])
        state = slstm_gates(pre, *state[1:])
        hs.append(state[0])
        if save:
            cs.append(state[1])
            ns.append(state[2])
            ms.append(state[3])
            pres.append(pre)
    if not save:
        cs, ns, ms = [state[1]], [state[2]], [state[3]]
        return (torch.stack(hs, dim=1), *(torch.stack(s, dim=1) for s in (cs, ns, ms)),
                xwb.new_empty((xwb.shape[0], 0, xwb.shape[2])))
    return tuple(torch.stack(s, dim=1) for s in (hs, cs, ns, ms, pres))


def slstm_scan_backward_plain(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT):
    """Plain torch version of the backward: a loop over t from S - 1 down to
    0 of the step's adjoint, carrying the state's gradients, the recurrent
    one ``dh[:, k-th slice] = dpre_t[:, k-th 4hd slice] @ r[k]^T``.
    Returns ``(dpre, dh0, dc0, dn0, dm0)``; ``dpre`` is ``dxwb``."""
    B, S, d = cs.shape
    H, hd = r.shape[0], r.shape[1]
    rT = r.transpose(1, 2)
    dpre = torch.empty_like(pre)
    dh, dc, dn, dm = torch.zeros_like(c0), dcT, dnT, dmT
    for t in range(S - 1, -1, -1):
        i_pre, f_pre, z_pre, o_pre = pre[:, t].split(d, dim=1)
        c, n, m = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t else (c0, n0, m0)
        c_new, n_new = cs[:, t], ns[:, t]
        lfm = F.logsigmoid(f_pre) + m
        m_new = torch.maximum(lfm, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(lfm - m_new)
        z_g = torch.tanh(z_pre)
        o_g = torch.sigmoid(o_pre)
        den = torch.clamp_min(n_new, 1.0)
        gh = dhs[:, t] + dh
        dq = gh / den
        gc = dc + dq * o_g
        # clamp_min passes the gradient at n == 1
        gn = dn + torch.where(n_new >= 1.0, -gh * (o_g * c_new) / (den * den), 0.0)
        ea = (gc * z_g + gn) * i_g
        eb = (gc * c + gn * n) * f_g
        dm_new = dm - ea - eb
        # maximum splits a tie half and half
        w_l = torch.where(lfm > i_pre, 1.0, torch.where(lfm < i_pre, 0.0, 0.5))
        dlfm = eb + dm_new * w_l
        dp = torch.cat([ea + dm_new * (1.0 - w_l), dlfm * torch.sigmoid(-f_pre),
                        gc * i_g * (1.0 - z_g * z_g), dq * c_new * o_g * (1.0 - o_g)], dim=1)
        dpre[:, t] = dp
        dc, dn, dm = gc * f_g, gn * f_g, dlfm
        dh = torch.bmm(dp.reshape(B, H, 4 * hd).transpose(0, 1), rT).transpose(0, 1).reshape(B, d)
    return dpre, dh, dc, dn, dm


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("slstm")
        lib.slstm_forward.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
        lib.slstm_backward.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        for fn in (lib.slstm_forward, lib.slstm_backward):
            fn.restype = ctypes.c_int
        lib.slstm_exchange_floats.argtypes = [ctypes.c_int] * 3
        lib.slstm_exchange_floats.restype = ctypes.c_longlong
        lib.slstm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.slstm_plan.restype = ctypes.c_int
        lib.slstm_sync_words.argtypes = []
        lib.slstm_sync_words.restype = ctypes.c_longlong
        lib.slstm_error_string.argtypes = [ctypes.c_int]
        lib.slstm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what} kernel launch failed: "
                          f"{lib.slstm_error_string(err).decode()} (error {err})")


#: the numbers :func:`slstm_plan` reads from the library, in its order
PLAN_FIELDS = ("code", "route", "registers", "blocks_an_sm", "grid", "groups_a_block",
               "span", "chunk", "chunks", "r_jobs_in_shared", "smem_bytes", "scratch_floats")


def slstm_plan(d: int, H: int, nsm: int, backward: bool = False) -> dict:
    """What a launch of width ``d`` with ``H`` heads takes one way on a card
    of ``nsm`` SMs, without launching (``csrc/slstm.cu`` ``plan_for``):
    ``route`` ("narrow" or "wide"); the narrow route's instance (``registers``:
    r's registers a column and lane; ``blocks_an_sm``); ``grid`` and
    ``groups_a_block`` (of 8 features); ``span``, the most heads a block's
    features touch; the wide route's staged ``chunk`` (columns) and
    ``chunks`` a step, and ``r_jobs_in_shared`` (of 4 columns of r each;
    the rest in device memory); ``smem_bytes`` (dynamic shared memory);
    ``scratch_floats`` after the exchange buffer; ``refused``, the
    library's reason, or None where the shape runs."""
    lib = load()
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    code = lib.slstm_plan(d, H, nsm, int(backward), ctypes.addressof(out))
    plan = dict(zip(PLAN_FIELDS, (int(v) for v in out)))
    plan["route"] = ("narrow", "wide")[plan["route"]]
    plan["refused"] = lib.slstm_error_string(code).decode() if code else None
    return plan


def _scratch(lib, d: int, H: int, backward: bool, like: torch.Tensor) -> torch.Tensor:
    """The buffer a launch on the current device needs besides its operands
    (the exchange buffer, and the forward's transposed r on the wide route),
    uninitialised."""
    n = lib.slstm_exchange_floats(d, H, int(backward))
    if n < 0:
        raise KernelError("the sLSTM kernels' library could not ask the device its SM count")
    return like.new_empty(n)


#: the sync states of eager launches, one a (device, stream) they launch on
_SYNC: dict = {}


def _sync_state(lib, device, stream: int) -> torch.Tensor:
    """The sync state of a launch on ``stream`` of ``device``:
    ``lib.slstm_sync_words()`` int64 words, the launch epoch and one flag a
    block (``csrc/slstm.cu`` lays them out). Each launch reads the epoch,
    stamps its blocks' flags with it plus the step and advances it at its
    end, so no flag of an earlier launch can pass for one of this launch,
    and no launch needs a zeroed counter of its own.

    Eager launches on one stream run in order, so they share one state,
    zeroed at the first and then kept; another stream gets its own. A
    launch captured into a CUDA graph gets a state of its own, allocated in
    the graph's pool with its zero fill captured in front of it: a graph's
    replays run on whatever stream the caller picks, beside other graphs'
    replays, and would race on a state they shared."""
    words = lib.slstm_sync_words()
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(words, dtype=torch.int64, device=device)
    key = (str(device), stream)
    state = _SYNC.get(key)
    if state is None:
        state = _SYNC[key] = torch.zeros(words, dtype=torch.int64, device=device)
    return state


def _launch(xwb, r, h0, c0, n0, m0, save: bool):
    """Launch the forward kernel on checked operands; returns ``(hs, cs,
    ns, ms, pre)`` as :func:`slstm_scan_plain`."""
    lib = load()
    B, S, d4 = xwb.shape
    d = d4 // 4
    hs = xwb.new_empty((B, S, d))
    cs, ns, ms = (xwb.new_empty((B, S if save else 1, d)) for _ in range(3))
    pre = xwb.new_empty((B, S if save else 0, d4))
    ptrs = [t.data_ptr() for t in (xwb, r, h0, c0, n0, m0, hs, cs, ns, ms)]
    with torch.cuda.device(xwb.device):
        xbuf = _scratch(lib, d, r.shape[0], False, xwb)
        stream = torch.cuda.current_stream(xwb.device).cuda_stream
        sync = _sync_state(lib, xwb.device, stream)
        err = lib.slstm_forward(*ptrs, pre.data_ptr() if save else None, xbuf.data_ptr(),
                                sync.data_ptr(), B, S, d, r.shape[0], int(save), stream)
    _check(lib, err, "slstm_scan")
    slstm_scan.launches += 1
    return hs, cs, ns, ms, pre


def _launch_backward(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT):
    """Launch the backward kernel on checked operands; returns ``(dpre,
    dh0, dc0, dn0, dm0)``."""
    lib = load()
    B, S, d = cs.shape
    dpre = torch.empty_like(pre)
    dh0, dc0, dn0, dm0 = (torch.empty_like(c0) for _ in range(4))
    ptrs = [t.data_ptr() for t in (r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT,
                                   dpre, dh0, dc0, dn0, dm0)]
    with torch.cuda.device(r.device):
        xbuf = _scratch(lib, d, r.shape[0], True, pre)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        sync = _sync_state(lib, r.device, stream)
        err = lib.slstm_backward(*ptrs, xbuf.data_ptr(), sync.data_ptr(), B, S, d, r.shape[0],
                                 stream)
    _check(lib, err, "slstm_scan_backward")
    slstm_scan_backward.launches += 1
    return dpre, dh0, dc0, dn0, dm0


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=(),
                         schema="(Tensor xwb, Tensor r, Tensor h0, Tensor c0, Tensor n0, "
                                "Tensor m0, bool save) -> "
                                "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def _op(xwb, r, h0, c0, n0, m0, save):
    """The forward kernel's launch as an op: :func:`_launch`."""
    return _launch(xwb, r, h0, c0, n0, m0, save)


@_op.register_fake
def _op_fake(xwb, r, h0, c0, n0, m0, save):
    """The forward on fake tensors: the outputs' shapes and dtypes, no
    launch."""
    slstm_scan.fake_calls += 1
    B, S, d4 = xwb.shape
    d = d4 // 4
    state = [xwb.new_empty((B, S if save else 1, d)) for _ in range(3)]
    return (xwb.new_empty((B, S, d)), *state, xwb.new_empty((B, S if save else 0, d4)))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=(),
                         schema="(Tensor r, Tensor pre, Tensor cs, Tensor ns, Tensor ms, "
                                "Tensor c0, Tensor n0, Tensor m0, Tensor dhs, Tensor dcT, "
                                "Tensor dnT, Tensor dmT) -> "
                                "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def _op_backward(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT):
    """The backward kernel's launch as an op: :func:`_launch_backward`."""
    return _launch_backward(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT)


@_op_backward.register_fake
def _op_backward_fake(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT):
    """The backward on fake tensors: (dpre, dh0, dc0, dn0, dm0)'s shapes
    and dtypes, no launch."""
    slstm_scan_backward.fake_calls += 1
    return (torch.empty_like(pre), *(torch.empty_like(c0) for _ in range(4)))


def products(B: int, S: int, d: int, hd: int) -> int:
    """The recurrent products' operations of one scan, either way: a
    multiply and an add for each of the 4 d x hd weights of a position of
    a row."""
    return 8 * B * S * d * hd


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _flops(xwb_shape, r_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, d4 = xwb_shape
    return products(B, S, d4 // 4, r_shape[1])


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _flops_backward(r_shape, pre_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, d4 = pre_shape
    return products(B, S, d4 // 4, r_shape[1])


def _check_operands(xwb, r, h0, c0, n0, m0) -> None:
    """Refuse operands of the wrong rank, shape, dtype or placement."""
    if xwb.dim() != 3 or xwb.shape[2] % 4 or r.dim() != 3:
        raise ValueError(f"xwb must be (B, S, 4d) and r (H, hd, 4 hd), got "
                         f"{tuple(xwb.shape)} and {tuple(r.shape)}")
    B, S, d4 = xwb.shape
    H, hd = r.shape[0], r.shape[1]
    if min(B, S, d4) < 1 or H * hd != d4 // 4 or r.shape[2] != 4 * hd:
        raise ValueError(f"r {tuple(r.shape)} does not fit xwb {tuple(xwb.shape)}: "
                         f"want (H, d / H, 4 d / H) with d = {d4 // 4}")
    for name, t in (("h0", h0), ("c0", c0), ("n0", n0), ("m0", m0)):
        if tuple(t.shape) != (B, d4 // 4):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {(B, d4 // 4)}")
    # the kernel takes float32; the plain version any one float dtype
    want = torch.float32 if xwb.device.type == "cuda" or not xwb.is_floating_point() \
        else xwb.dtype
    for name, t in (("xwb", xwb), ("r", r), ("h0", h0), ("c0", c0), ("n0", n0), ("m0", m0)):
        if t.dtype != want or t.device != xwb.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the scan takes "
                             f"{want} on {xwb.device}")


class SLSTMScan(torch.autograd.Function):
    """The scan with its backward: the forward kernel (or, with ``on_card``
    False, the plain version) keeping every step's state and
    pre-activations; the backward is :func:`slstm_scan_backward` and one
    ``torch.bmm`` for ``dr``. Returns (hs, cT, nT, mT); hT is hs's last
    position."""

    @staticmethod
    def forward(ctx, xwb, r, h0, c0, n0, m0, on_card: bool):
        run = _op if on_card else slstm_scan_plain
        hs, cs, ns, ms, pre = run(xwb, r, h0, c0, n0, m0, True)
        ctx.save_for_backward(r, h0, c0, n0, m0, hs, cs, ns, ms, pre)
        return hs, *(s.select(1, -1).clone() for s in (cs, ns, ms))

    @staticmethod
    def backward(ctx, dhs, dcT, dnT, dmT):
        r, h0, c0, n0, m0, hs, cs, ns, ms, pre = ctx.saved_tensors
        B, S, d = hs.shape
        H, hd = r.shape[0], r.shape[1]
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        dcT, dnT, dmT = (torch.zeros_like(c0) if g is None else g.contiguous()
                         for g in (dcT, dnT, dmT))
        dpre, dh0, dc0, dn0, dm0 = slstm_scan_backward(r, pre, cs, ns, ms, c0, n0, m0,
                                                       dhs, dcT, dnT, dmT)
        dr = None
        if ctx.needs_input_grad[1]:  # sum over (b, t) of h_{t-1}^T dpre_t, per head
            h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).reshape(B * S, H, hd)
            dr = torch.bmm(h_prev.transpose(0, 1).transpose(1, 2),
                           dpre.reshape(B * S, H, 4 * hd).transpose(0, 1))
        return dpre, dr, dh0, dc0, dn0, dm0, None


def slstm_scan_backward(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT):
    """The backward of the scan: given ``r``, what the forward saved (the
    pre-activations (B, S, 4d) and the state after every step (B, S, d)),
    the initial state and the incoming gradients of every ``h_t`` and of
    the final c, n, m, returns ``(dxwb, dh0, dc0, dn0, dm0)``.

    All float32 on one device (the plain version takes any one float
    dtype). CUDA tensors go through the kernel
    (``slstm_scan_backward.launches`` counts the launches) and must be
    contiguous; CPU tensors go through :func:`slstm_scan_backward_plain`.
    """
    B, S, d = cs.shape
    for name, t, shape in (("pre", pre, (B, S, 4 * d)), ("ns", ns, (B, S, d)),
                           ("ms", ms, (B, S, d)), ("dhs", dhs, (B, S, d)),
                           ("c0", c0, (B, d)), ("n0", n0, (B, d)), ("m0", m0, (B, d)),
                           ("dcT", dcT, (B, d)), ("dnT", dnT, (B, d)), ("dmT", dmT, (B, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != cs.dtype or t.device != cs.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the backward takes "
                             f"{cs.dtype} on {cs.device}, as cs is")
    if cs.device.type == "cuda":
        ops = (r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT)
        if cs.dtype != torch.float32 or r.dtype != torch.float32:
            raise ValueError(f"the slstm_scan_backward kernel takes float32, got {cs.dtype}")
        if not all(t.is_contiguous() for t in ops):
            raise ValueError("the slstm_scan_backward kernel takes contiguous operands")
        return _op_backward(*ops)
    if cs.device.type == "cpu":
        return slstm_scan_backward_plain(r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT)
    raise ValueError(f"slstm_scan_backward runs on cuda or cpu, not {cs.device}")


def slstm_scan(xwb, r, h0, c0, n0, m0):
    """The sLSTM recurrence over every position of ``xwb`` from the state
    ``(h0, c0, n0, m0)``.

    xwb: (B, S, 4d) float32, ``x @ w_x`` plus the bias; r: (H, hd, 4 hd)
    float32; the state (B, d) float32 each; all on one device (on the CPU
    any one float dtype, the plain version's). Returns
    ``(hs, hT, cT, nT, mT)``: hs (B, S, d) and the final state (B, d).
    CUDA tensors go through the kernel (``slstm_scan.launches`` counts the
    launches); CPU tensors through :func:`slstm_scan_plain`.
    Differentiable (see :class:`SLSTMScan`).
    """
    _check_operands(xwb, r, h0, c0, n0, m0)
    dev = xwb.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"slstm_scan runs on cuda or cpu, not {dev}")
    on_card = dev.type == "cuda"
    ops = (xwb, r, h0, c0, n0, m0)
    if on_card:
        ops = tuple(t.contiguous() for t in ops)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        hs, cT, nT, mT = SLSTMScan.apply(*ops, on_card)
        return hs, hs.select(1, -1), cT, nT, mT
    hs, cs, ns, ms, _ = (_op if on_card else slstm_scan_plain)(*ops, False)
    # select and clone, not indexing and contiguous: a CPU-only torch does
    # neither of the latter on a fake CUDA tensor (the dry-run's tests)
    return hs, hs.select(1, -1).clone(), *(s.select(1, 0) for s in (cs, ns, ms))


#: launches of the forward and the backward CUDA kernels in this process
#: (plain-version calls excluded)
slstm_scan.launches = 0
slstm_scan_backward.launches = 0
#: calls of their fake forms (a trace on fake tensors; no launch)
slstm_scan.fake_calls = 0
slstm_scan_backward.fake_calls = 0
