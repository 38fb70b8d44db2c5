"""Small shared helpers for the observability plane (and its clients)."""
from __future__ import annotations

from collections import Counter as _Counter
from typing import Dict, Iterable, TypeVar

import numpy as np

T = TypeVar("T")


def tally(items: Iterable[T]) -> Dict[T, int]:
    """Count occurrences of each item — the one aggregation helper shared by
    ``service/metrics.py`` and the obs metrics plane."""
    return dict(_Counter(items))


def json_safe(obj):
    """Recursively convert numpy scalars/arrays (and tuples) into plain
    Python types so ``json.dumps`` succeeds on nested report structures.

    Dict *keys* are converted too — ``{np.int64(3): ...}`` shows up in
    per-bucket tallies.
    """
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {_safe_key(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def _safe_key(k):
    if isinstance(k, np.generic):
        return k.item()
    return k
