"""Core datatypes for the OEF scheduling framework.

The paper (OEF, Middleware '24) operates on:
  - a cluster of ``k`` accelerator *types*, type ``j`` having ``m_j`` devices;
  - ``n`` tenants, tenant ``l`` described by a *speedup vector*
    ``W_l = <w_l^1 .. w_l^k>`` (training throughput on each type, normalized to
    the slowest type so ``w_l^1 == 1``);
  - an *allocation matrix* ``X (n x k)`` of fractional device shares.

These types are deliberately plain (numpy + dataclasses): the scheduler is the
cluster control plane and must not initialize any accelerator runtime.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class DeviceTypeSpec:
    """One accelerator generation in the heterogeneous fleet.

    The paper uses RTX 3070/3080/3090; we model TPU generations. ``peak_tflops``
    is bf16 dense peak per chip, ``hbm_gbps`` is HBM bandwidth per chip and
    ``ici_gbps`` per-link interconnect bandwidth — these feed the analytic
    profiler that replaces the paper's measured mini-batch profiling runs.
    """

    name: str
    peak_tflops: float
    hbm_gbps: float
    ici_gbps: float
    hbm_gib: float = 16.0
    devices_per_host: int = 4  # paper: 4 GPUs of one type per host


# Canonical heterogeneous fleet used throughout benchmarks (slowest first —
# the paper normalizes speedups to the slowest type).
TPU_FLEET: Tuple[DeviceTypeSpec, ...] = (
    DeviceTypeSpec("tpu-v5e", peak_tflops=197.0, hbm_gbps=819.0, ici_gbps=50.0, hbm_gib=16.0),
    DeviceTypeSpec("tpu-v4", peak_tflops=275.0, hbm_gbps=1228.0, ici_gbps=50.0, hbm_gib=32.0),
    DeviceTypeSpec("tpu-v5p", peak_tflops=459.0, hbm_gbps=2765.0, ici_gbps=100.0, hbm_gib=95.0),
    DeviceTypeSpec("tpu-v6e", peak_tflops=918.0, hbm_gbps=1640.0, ici_gbps=100.0, hbm_gib=32.0),
)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Device-type inventory: ``m[j]`` devices of type ``types[j]``."""

    types: Tuple[str, ...]
    m: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.types) != len(self.m):
            raise ValueError("types/m length mismatch")
        if any(c < 0 for c in self.m):
            raise ValueError("negative device count")

    @property
    def k(self) -> int:
        return len(self.types)

    @property
    def m_vec(self) -> Array:
        return np.asarray(self.m, dtype=np.float64)

    @property
    def total_devices(self) -> int:
        return int(sum(self.m))

    @staticmethod
    def paper_cluster() -> "ClusterSpec":
        """The paper's evaluation cluster: 8x 3070, 8x 3080, 8x 3090."""
        return ClusterSpec(types=("rtx3070", "rtx3080", "rtx3090"), m=(8, 8, 8))


@dataclasses.dataclass(frozen=True)
class JobTypeProfile:
    """A tenant job type: its speedup vector plus worker demand metadata."""

    name: str
    speedup: Tuple[float, ...]  # length k, speedup[0] normalized to 1.0
    min_demand: int = 1  # smallest worker count a job of this type can run with

    def speedup_vec(self) -> Array:
        return np.asarray(self.speedup, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """A tenant with a priority weight and >= 1 job types (§4.2.3/4.2.4)."""

    name: str
    job_types: Tuple[JobTypeProfile, ...]
    weight: float = 1.0

    def __post_init__(self) -> None:
        if not self.job_types:
            raise ValueError(f"tenant {self.name} has no job types")
        if self.weight <= 0:
            raise ValueError("weight must be positive")


_ROW_NAMES: List[str] = []


def default_rows(n: int) -> Tuple[str, ...]:
    """Shared ``("u0", ..., "u{n-1}")`` row names for anonymous solves.

    Every solver labels rows this way when no tenant names are given; at
    1024 users formatting the names costs ~0.4 ms per solve, which matters
    on the online service's re-solve path where the user count drifts by a
    few tenants between solves — so the names are built once into a global
    prefix list and each call only slices it.
    """
    while len(_ROW_NAMES) < n:
        _ROW_NAMES.append(f"u{len(_ROW_NAMES)}")
    return tuple(_ROW_NAMES[:n])


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Result of a fair-share evaluation.

    ``X`` is the per-(row, type) fractional share matrix. ``rows`` names each
    row; after virtual-user folding, one row per tenant. ``throughput`` is the
    normalized throughput ``W_l . x_l`` per row.
    """

    X: Array
    rows: Tuple[str, ...]
    W: Array
    m: Array
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def throughput(self) -> Array:
        return np.einsum("lk,lk->l", self.W, self.X)

    @property
    def total_efficiency(self) -> float:
        return float(self.throughput.sum())

    def row_index(self, name: str) -> int:
        return self.rows.index(name)


def validate_speedup_matrix(W: Array, *, normalized: bool = True, tol: float = 1e-9) -> None:
    """Sanity-check a speedup matrix per §2.3 of the paper.

    - entries strictly positive;
    - if ``normalized``, first column is all ones (throughput normalized to the
      slowest type).
    """
    W = np.asarray(W, dtype=np.float64)
    if W.ndim != 2:
        raise ValueError("speedup matrix must be 2-D (n x k)")
    if np.any(W <= 0):
        raise ValueError("speedup entries must be strictly positive")
    if normalized and np.any(np.abs(W[:, 0] - 1.0) > tol):
        raise ValueError("speedup matrix not normalized: first column must be 1")


def normalize_speedup_matrix(W: Array) -> Array:
    """Normalize throughputs to the slowest (first) type: ``w_l^1 = 1``."""
    W = np.asarray(W, dtype=np.float64)
    return W / W[:, :1]


def monotone_types(W: Array) -> bool:
    """True if every user's speedups are non-decreasing across types.

    The paper sorts device types slowest-to-fastest and assumes this holds
    ("the slowest GPU type for different DL jobs is consistent"). Some derived
    TPU speedup matrices violate it (compute- vs memory-bound jobs rank
    generations differently); OEF's LPs don't require it, but the adjacency
    theorem (Thm 5.2) does.
    """
    W = np.asarray(W, dtype=np.float64)
    return bool(np.all(np.diff(W, axis=1) >= -1e-12))
