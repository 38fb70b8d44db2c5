"""Operations and bytes of one launch of the sLSTM scan kernels
(``csrc/slstm.cu`` of the port), from the shapes alone.

The operations are the recurrent products, a multiply and an add for each
of the 4 d x hd weights of ``r`` at each position of each row, either way:
2 B H hd 4hd S. Bytes count each input read once and each output written
once, in float32:

  - forward: reads ``xwb`` (B, S, 4d), ``r`` and the initial state (4 B d);
    writes every h (B, S, d) and, when it keeps what the backward needs
    (training), the state after every step (3 B S d) and the
    pre-activations (B, S, 4d), else the final c, n, m (3 B d);
  - backward: reads ``r``, the pre-activations, the saved states (3 B S d),
    the initial state's c, n, m (3 B d), the gradients of every h and of
    the final c, n, m; writes the pre-activations' gradient and the
    initial state's four gradients.

The bound is the larger of the operations at the FP32 rate and the bytes
at the memory's rate.
"""
from __future__ import annotations


def ops(B: int, S: int, d: int, H: int) -> int:
    hd = d // H
    return 2 * B * H * hd * 4 * hd * S


def bytes_forward(B: int, S: int, d: int, H: int, save: bool) -> int:
    r = 4 * d * (d // H)
    reads = B * S * 4 * d + r + 4 * B * d
    writes = B * S * d + (3 * B * S * d + B * S * 4 * d if save else 3 * B * d)
    return 4 * (reads + writes)


def bytes_backward(B: int, S: int, d: int, H: int) -> int:
    r = 4 * d * (d // H)
    reads = r + B * S * 4 * d + 3 * B * S * d + 3 * B * d + B * S * d + 3 * B * d
    writes = B * S * 4 * d + 4 * B * d
    return 4 * (reads + writes)


def bound_s(n_ops: int, n_bytes: int, peaks: dict) -> float:
    return max(n_ops / peaks["fp32_flops"], n_bytes / peaks["hbm_bytes_s"])
