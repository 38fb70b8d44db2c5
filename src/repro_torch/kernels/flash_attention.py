"""Flash attention forward: the CUDA kernel and its plain version.

Softmax attention over (B, H, S, D) queries, keys and values, float32 or
bfloat16, with float32 scores and accumulation and the output in q's dtype:

    out = softmax(q k^T / sqrt(D), masked to -1e30) v

where key ``k`` is hidden from query ``q`` when ``causal`` and ``q < k``, or
when a ``window`` is given and ``q - k >= window``. Key ``k`` is at position
``k`` and query row ``i`` at ``q_offset + i`` (default 0; a sequence block's
start where the queries are one rank's block of a sequence whose keys are
all given, as a prefill split over the ``model`` axis calls it), also when
Sq != Sk. A query that sees no key at all gets the mean of V over all keys,
as the oracle ``ref.attention_ref`` gives it.

:func:`flash_attention` (equal heads) and :func:`flash_attention_gqa`
(``Hq`` a multiple of ``Hkv``) take the JAX package's signatures
(``repro/kernels/ops.py``) less ``interpret``. On CUDA tensors they launch
a hand-written kernel of ``csrc/flash_attention.cu`` (built with ``nvcc``
on first use, see :mod:`repro_torch.kernels._build`), which reads KV head
``h // (Hq // Hkv)`` for query head ``h`` without copying it; on CPU
tensors they run :func:`flash_attention_plain`, the oracle's arithmetic.

Two kernels, chosen by :func:`_path_for` from the dtype, D and the
operands' alignment alone (never on failure):

  - ``"tensor_core"``: bf16 with D % 8 == 0 and 16-byte aligned operands
    (what TMA needs) go to the Hopper kernel, wgmma products fed by TMA;
  - ``"cuda_core"``: everything else (float32; bf16 with another D or a
    misaligned view) goes to the float32-FMA kernel, which keeps float32
    within 1e-5 of the oracle.

There is no other route: a CUDA tensor never falls back to the plain
version or to the other kernel, a failed build or launch raises
``KernelError``, and an input that requires grad raises ``RuntimeError``
(the kernels have no backward). ``flash_attention.launches`` counts the
launches of both kernels, ``flash_attention.launches_tc`` those of the
tensor-core kernel.

The launch is the custom op ``torch.ops.repro_torch.flash_attention``,
whose body is :func:`_launch`. Its fake form gives the output's shape and
dtype and launches nothing, so a trace under ``FakeTensorMode`` (the
dry-run, ``repro_torch.launch.dryrun``) runs the card's path on fake CUDA
tensors; ``flash_attention.fake_calls`` counts those calls apart from the
launches, and :func:`flash_flops` is the op's formula for
``torch.utils.flop_counter``: ``4 D`` operations for each query-key pair
the mask leaves visible (:func:`visible_pairs`), per query head.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import attention_ref
from ._build import KernelError

#: operand dtypes the kernel takes, and their codes in csrc/flash_attention.cu.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dimension the kernel takes.
MAX_D = 256
#: query rows per block of the CUDA-core kernel (``kBQ``; the tensor-core
#: kernel's are 128); the grid's second dimension holds ceil(Sq / 64) <= 65535
#: tiles.
BLOCK_Q = 64
#: the two kernels, as :func:`_path_for` names them.
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"


def _path_for(dtype, D: int, ptrs) -> str:
    """The kernel for operands of ``dtype`` and head dimension ``D`` at the
    addresses ``ptrs``: :data:`TENSOR_CORE` for bf16 with D % 8 == 0 and
    every address 16-byte aligned (TMA's rows and bases), else
    :data:`CUDA_CORE`."""
    if dtype == torch.bfloat16 and D % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return TENSOR_CORE
    return CUDA_CORE


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0):
    """Plain torch version: ``ref.attention_ref`` on KV heads repeated to
    q's head count, query row i at position ``q_offset + i``. Returns
    (B, Hq, Sq, D) in q's dtype."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


_LIB = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, setting its C
    signatures once; raises :class:`~repro_torch.kernels.KernelError` when
    ``nvcc`` is missing or the build fails."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                           + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_tc.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(q, k, v, causal: bool, window, q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel :func:`_path_for` picks on checked operands;
    returns (B, Hq, Sq, D) in q's dtype."""
    _build.refuse_grad("flash_attention", q=q, k=k, v=v)
    lib = load()
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    # a window at or past the last row's position + 1 hides nothing, one at
    # or below -Sk hides all
    w = 0 if window is None else max(min(int(window), q_offset + Sq), -Sk)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tc = _path_for(q.dtype, D, ptrs) == TENSOR_CORE
    args = (*ptrs, B, Hq, Hkv, Sq, Sk, D, int(bool(causal)), int(window is not None), w,
            int(q_offset), 1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tc:
            err = lib.flash_attention_tc(*args, stream)
        else:
            err = lib.flash_attention(*args, DTYPES[q.dtype], stream)
    if err != 0:
        raise KernelError(
            f"flash_attention {TENSOR_CORE if tc else CUDA_CORE} kernel launch "
            f"failed: {lib.flash_error_string(err).decode()} (error {err})")
    flash_attention.launches += 1
    flash_attention.launches_tc += int(tc)
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window, "
                                "int q_offset) -> Tensor")
def _op(q, k, v, causal, window, q_offset):
    """The kernel's launch as an op: :func:`_launch`."""
    return _launch(q, k, v, causal, window, q_offset)


@_op.register_fake
def _op_fake(q, k, v, causal, window, q_offset):
    """The op on fake tensors: the output's shape and dtype, no launch."""
    flash_attention.fake_calls += 1
    return torch.empty_like(q)


def visible_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """The query-key pairs the mask leaves visible: key ``j`` to query row
    ``i`` (at position ``q_offset + i``) unless ``causal`` and ``j`` is past
    it, or a ``window`` is given and ``j`` lies ``window`` or more before
    it."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(pos - int(window) + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset, *args, out_shape=None,
                **kwargs) -> int:
    """The operations of one call: ``4 D`` (``q.k`` and ``p.v``, a multiply
    and an add each) for every visible pair of every query head."""
    B, Hq, Sq, D = q_shape
    return B * Hq * visible_pairs(Sq, k_shape[2], causal, window, q_offset) * 4 * D


def _check_blocks(Sq: int, Sk: int, block_q: int, block_k: int) -> None:
    """Refuse what the JAX op refuses: sequence lengths its tiles do not
    divide (``repro/kernels/flash_attention.py``). The kernel's own tiles
    are its own and mask a ragged edge."""
    if block_q < 1 or block_k < 1 or Sq % block_q or Sk % block_k:
        raise ValueError(
            f"sequence lengths (Sq={Sq}, Sk={Sk}) must be divisible by the "
            f"tile shapes (block_q={block_q}, block_k={block_k}); pad the "
            f"inputs or pass smaller blocks")


def _check(q, k, v) -> None:
    """Refuse operands of the wrong rank, shape, dtype or placement."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v one (B, Hkv, Sk, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k and v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         f"in batch or head dimension")
    if min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError(f"flash_attention needs non-empty operands, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _route(q, k, v, causal: bool, window, q_offset: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q_offset < 0 or q_offset + q.shape[2] > 2**31 - 1:
        raise ValueError(f"q_offset must be >= 0 with q_offset + Sq < 2**31, got "
                         f"{q_offset} and Sq {q.shape[2]}")
    dev = q.device
    if dev.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        B, Hq, Sq, D = q.shape
        if D > MAX_D:
            raise ValueError(f"the flash_attention kernel takes D <= {MAX_D}, got {D}")
        if B * Hq > 2**31 - 1 or -(-Sq // BLOCK_Q) > 65535 or k.shape[2] > 2**31 - 1:
            raise ValueError(f"the flash_attention kernel takes B * Hq < 2**31 and "
                             f"Sq <= {65535 * BLOCK_Q}, got {tuple(q.shape)}")
        _build.refuse_grad("flash_attention", q=q, k=k, v=v)
        return _op(q, k, v, causal, None if window is None else int(window), int(q_offset))
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    block_q: int = 128, block_k: int = 128, q_offset: int = 0) -> torch.Tensor:
    """(B, H, S, D) flash attention. GQA: repeat KV heads in the caller or
    use :func:`flash_attention_gqa`. ``block_q`` / ``block_k`` only refuse
    the sequence lengths the JAX op refuses; ``q_offset`` is query row 0's
    position."""
    _check(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q has {q.shape[1]} heads and k {k.shape[1]}; use "
                         f"flash_attention_gqa for grouped KV heads")
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    return _route(q, k, v, causal, window, q_offset)


def flash_attention_gqa(q, k, v, *, causal: bool = True, window=None,
                        block_q: int = 128, block_k: int = 128, q_offset: int = 0
                        ) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) with Hq % Hkv == 0. Query head
    h attends with KV head h // (Hq // Hkv); query row i sits at position
    ``q_offset + i``."""
    _check(q, k, v)
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q's {q.shape[1]} heads are not a multiple of k's "
                         f"{k.shape[1]}")
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    return _route(q, k, v, causal, window, q_offset)


#: launches of either CUDA kernel in this process, from either wrapper
#: (plain-version calls excluded), and of the tensor-core kernel alone.
flash_attention.launches = 0
flash_attention.launches_tc = 0
#: calls of the op's fake form (a trace on fake tensors; no launch)
flash_attention.fake_calls = 0
