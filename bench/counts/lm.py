"""Operation counts of a decoder-only language model's step, from the
configuration file's ``run`` sizes: what the model must compute, not what
an implementation happens to run.

``matrix_params`` counts the weights that enter a matrix product once a
token: every projection, the sLSTM recurrence ``r`` and the tied table
once, as the unembedding of the ``vocab`` real rows (the lookup is no
product; norm scales and biases are no products either). The quadratic
term of causal attention counts the S (S + 1) / 2 query-key pairs of a row,
for its two products (scores and the weighted sum of values). The mLSTM's
pairwise products inside its chunks are not counted, and neither is what
``remat`` recomputes.
"""
from __future__ import annotations


def _layer_params(run: dict, kind: str) -> int:
    d, H, K, hd = run["d_model"], run["n_heads"], run["n_kv_heads"], run["head_dim"]
    if kind == "full":
        return d * H * hd + 2 * d * K * hd + H * hd * d
    if kind == "mlstm":
        di = 2 * d
        return d * 2 * di + 3 * di * di + d * 2 * H + di * d
    if kind == "slstm":
        return d * 4 * d + H * (d // H) * 4 * (d // H) + d * d
    raise NotImplementedError(kind)


def _kinds(run: dict) -> list:
    pat = list(run["pattern"])
    units, tail = divmod(run["n_layers"], len(pat))
    return pat * units + pat[:tail]


def table_params(run: dict) -> int:
    return run["vocab"] * run["d_model"]


def matrix_params(run: dict) -> int:
    ffn = 3 * run["d_model"] * run["d_ff"]
    return table_params(run) + sum(_layer_params(run, k) + ffn for k in _kinds(run))


def attention_flops(run: dict, B: int, S: int) -> int:
    """Forward operations of causal attention's two products, all layers."""
    n_full = sum(k == "full" for k in _kinds(run))
    pairs = S * (S + 1) // 2
    return n_full * 2 * (2 * B * run["n_heads"] * run["head_dim"] * pairs)


def train_flops(run: dict, B: int, S: int) -> int:
    """One training step of B rows of S tokens: 6 N T plus three times the
    attention term (forward and backward)."""
    return 6 * matrix_params(run) * B * S + 3 * attention_flops(run, B, S)


def prefill_flops(run: dict, B: int, S: int) -> int:
    """One prefill of B prompts of S tokens: 2 N T without the table, the
    last position's unembedding, and the attention term."""
    body = matrix_params(run) - table_params(run)
    return 2 * body * B * S + 2 * table_params(run) * B + attention_flops(run, B, S)
