"""Collective-bytes accounting for the roofline: the port of
``repro.launch.hlo_analysis``.

The JAX dry-run parses the per-device HLO for its collectives and their
operand and result bytes. The port has no compiler and no HLO: its
collectives are the calls of ``repro_torch.distributed.parallel``, which
counts each by kind with this rank's input bytes (``parallel.COUNTS``)
and result bytes (``parallel.RESULT_BYTES``). :func:`collective_stats`
turns those counts into the JAX record, with JAX's per-device wire bytes
for a ring:

  all-reduce          2 x operand   (reduce-scatter + all-gather phases)
  all-gather          1 x result    (each device receives result minus own shard)
  reduce-scatter      1 x operand
  all-to-all          1 x operand
  collective-permute  1 x operand

The HLO text parser of the JAX module (``_shapes_bytes``, ``_DEF_RE``) has
no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

#: the port's collective kinds under the JAX (HLO) op names; a max
#: all-reduce is an all-reduce in HLO
OP_NAMES = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_max": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "collective_permute": "collective-permute",
}

_WIRE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_stats(counts: Optional[Mapping[str, Sequence[int]]] = None,
                     result_bytes: Optional[Mapping[str, int]] = None) -> Dict[str, object]:
    """The JAX ``collective_stats`` record of ``counts`` (kind -> [calls,
    input bytes], ``parallel.COUNTS``' form) and ``result_bytes`` (kind ->
    result bytes, ``parallel.RESULT_BYTES``'), both by default the counts
    this process has made since ``parallel.reset_counts``: ``per_op`` under
    the HLO op names with ``count``, ``operand_bytes`` and ``wire_bytes``,
    then ``wire_bytes_per_device``, ``operand_bytes_per_device`` and
    ``n_collectives``."""
    if counts is None or result_bytes is None:
        from ..distributed import parallel as P

        counts = P.COUNTS if counts is None else counts
        result_bytes = P.RESULT_BYTES if result_bytes is None else result_bytes
    per_op: Dict[str, Dict[str, float]] = {}
    wire_total = 0.0
    raw_total = 0
    count = 0
    for kind in sorted(counts):
        calls, op_bytes = int(counts[kind][0]), int(counts[kind][1])
        base = OP_NAMES[kind]
        if base == "all-gather":
            wire = _WIRE_MULT[base] * result_bytes.get(kind, op_bytes)
        else:
            wire = _WIRE_MULT[base] * op_bytes
        d = per_op.setdefault(base, {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += calls
        d["operand_bytes"] += op_bytes
        d["wire_bytes"] += wire
        wire_total += wire
        raw_total += op_bytes
        count += calls
    return {
        "per_op": per_op,
        "wire_bytes_per_device": wire_total,
        "operand_bytes_per_device": raw_total,
        "n_collectives": count,
    }
