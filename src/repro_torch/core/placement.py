"""Placement optimization (§4.3): deviation-accumulating rounding + host packing.

The fair-share evaluator emits *fractional* shares. Each scheduling round the
placer:
  1. rounds shares to whole devices with per-(user, type) deviation
     accumulation — ``real_j(t) = round(ideal_j(t) + dev_j(t))``,
     ``dev_j(t+1) = dev_j(t) + ideal_j(t) - real_j(t)`` — so long-run averages
     converge to the fractional ideal (bounded deviation, tested);
  2. zeroes a user's share when it is below their minimum job demand
     (``real_j(t) := 0 if real_j(t) < min_k demand_k``), letting deviation
     build until the user can run at least one job (anti-starvation);
  3. packs jobs onto hosts, granting placement priority to jobs with more
     workers (collective-communication contention, §4.3) and preferring
     single-type placements (straggler avoidance, §4.4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray


@dataclasses.dataclass
class JobRequest:
    """A runnable job: ``workers`` devices wanted, owned by ``user``."""

    user: int
    job_id: str
    workers: int
    starvation: float = 0.0  # rounds since last scheduled (priority key)


@dataclasses.dataclass
class PlacementResult:
    real: Array  # (n, k) integer devices granted
    assignments: Dict[str, List[Tuple[int, int, int]]]  # job -> [(type, host, count)]
    cross_host_jobs: int
    cross_type_workers: int
    unplaced_jobs: List[str]


class RoundingPlacer:
    """Stateful rounding from fractional shares to integer device grants."""

    def __init__(self, n_users: int, m: Sequence[int], devices_per_host: int = 4):
        self.n = n_users
        self.m = np.asarray(m, dtype=np.int64)
        self.k = len(self.m)
        self.dev = np.zeros((n_users, self.k))
        self.devices_per_host = devices_per_host
        # hosts[j] = list of free-slot counts, one per host of type j
        self.hosts_per_type = [
            int(np.ceil(mj / devices_per_host)) for mj in self.m
        ]

    # -- step 1+2: rounding ------------------------------------------------
    def round_shares(self, ideal: Array, min_demand: Optional[Array] = None,
                     capacity: Optional[Array] = None) -> Array:
        """Largest-remainder rounding of ``ideal + dev`` with capacity repair.

        ``min_demand[l]`` is the smallest worker count any of user l's jobs can
        run with; grants smaller than it are deferred (deviation keeps them).

        ``capacity`` is the per-type device budget to round against — the
        online service passes its post-failure effective capacity here so
        integer grants never exceed what :meth:`place` can actually pack
        after masking down hosts. Defaults to the full cluster ``m``.
        """
        ideal = np.asarray(ideal, dtype=np.float64)
        if ideal.shape != (self.n, self.k):
            raise ValueError(
                f"ideal share matrix has shape {ideal.shape}, expected "
                f"(n={self.n}, k={self.k}); rebuild the placer when the "
                f"tenant set or cluster changes"
            )
        cap = self.m if capacity is None else np.asarray(capacity, dtype=np.int64)
        if cap.shape != self.m.shape:
            raise ValueError(
                f"capacity has shape {cap.shape}, expected {self.m.shape}")
        target = ideal + self.dev
        real = np.zeros((self.n, self.k), dtype=np.int64)
        for j in range(self.k):
            col = np.clip(target[:, j], 0.0, None)
            budget = int(min(cap[j], np.floor(col.sum() + 1e-9)))
            base = np.floor(col).astype(np.int64)
            overflow = base.sum() - budget
            if overflow > 0:  # too many from floors alone (dev drift) — trim
                order = np.argsort(col - base)  # smallest remainder first
                for idx in order:
                    if overflow == 0:
                        break
                    take = min(base[idx], overflow)
                    base[idx] -= take
                    overflow -= take
            remaining = budget - base.sum()
            rema = col - np.floor(col)
            order = np.argsort(-rema, kind="stable")
            for idx in order[: max(remaining, 0)]:
                base[idx] += 1
            real[:, j] = base
        if min_demand is not None:
            md = np.asarray(min_demand, dtype=np.int64)
            too_small = (real.sum(axis=1) < md) & (real.sum(axis=1) > 0)
            real[too_small, :] = 0
            # redistribute devices freed by gating: give them to the users
            # with the largest outstanding target who can actually use them
            # (work conservation — idle grants would depress throughput).
            for j in range(self.k):
                freed = int(min(cap[j], np.floor(np.clip(target[:, j], 0, None).sum() + 1e-9))
                            ) - int(real[:, j].sum())
                while freed > 0:
                    resid = target[:, j] - real[:, j]
                    resid[too_small] = -np.inf  # gated users stay gated this round
                    cand = int(np.argmax(resid))
                    if not np.isfinite(resid[cand]):
                        break
                    real[cand, j] += 1
                    freed -= 1
                    if real[cand].sum() < md[cand]:
                        # still below their min demand — undo and stop trying j
                        real[cand, j] -= 1
                        target[cand, j] = -np.inf
                        freed += 1
                        if not np.any(np.isfinite(target[:, j])):
                            break
                        continue
        self.dev += ideal - real
        # keep deviation bounded even under persistent gating
        np.clip(self.dev, -2.0 * self.m.max(), 2.0 * self.m.max(), out=self.dev)
        return real

    # -- step 3: host packing ----------------------------------------------
    def place(
        self,
        real: Array,
        jobs: Sequence[JobRequest],
        *,
        jobs_per_user_order: Optional[Dict[int, List[str]]] = None,
        naive: bool = False,
        prev: Optional[Dict[str, List[Tuple[int, int, int]]]] = None,
        down_hosts: Optional[set] = None,
    ) -> PlacementResult:
        """Pack jobs onto hosts.

        Optimized mode (§4.3, OEF's placer): placement priority to jobs with
        more workers (network contention), each job prefers a single device
        type (fastest granted, straggler avoidance §4.4) and a single host
        when it fits.

        ``naive=True`` models the baselines' native placers (paper §6.3.1:
        Gavel/Gandiva_fair "lack optimization strategies for placement"):
        FIFO order, types filled slowest-first, first-fit across hosts with
        no single-host/single-type preference.

        ``down_hosts`` is a set of ``(type, host)`` pairs currently failed
        (online service): their slots are masked so no job is placed there.
        When the integer grants in ``real`` exceed the surviving slots of any
        type, placement raises ``ValueError`` with the per-type shortfall —
        the caller rounded against pre-failure capacity (pass the effective
        capacity to :meth:`round_shares`) and silently dropping jobs here
        would hide the accounting bug.
        """
        free = []  # free[j] = array of free slots per host of type j
        for j in range(self.k):
            n_hosts = self.hosts_per_type[j]
            slots = np.full(n_hosts, self.devices_per_host, dtype=np.int64)
            # cap total slots at m_j
            extra = slots.sum() - self.m[j]
            if extra > 0:
                slots[-1] -= extra
            if down_hosts:
                for h in range(n_hosts):
                    if (j, h) in down_hosts:
                        slots[h] = 0
            free.append(slots)
        shortfall = {
            j: (int(real[:, j].sum()), int(free[j].sum()))
            for j in range(self.k) if int(real[:, j].sum()) > int(free[j].sum())
        }
        if shortfall:
            detail = ", ".join(
                f"type {j}: granted {g} > {a} surviving slots (short {g - a})"
                for j, (g, a) in sorted(shortfall.items()))
            raise ValueError(
                f"integer grants exceed post-failure capacity — {detail}; "
                f"round_shares() must be given the effective capacity "
                f"(down hosts: {sorted(down_hosts) if down_hosts else []})")
        user_budget = real.copy().astype(np.int64)

        if naive:
            order = sorted(jobs, key=lambda r: r.job_id)  # FIFO, no priority
            type_order = list(range(self.k))  # slowest types first
        else:
            order = sorted(jobs, key=lambda r: (-r.workers, -r.starvation, r.job_id))
            type_order = list(range(self.k - 1, -1, -1))  # fastest first
        assignments: Dict[str, List[Tuple[int, int, int]]] = {}
        cross_host = 0
        cross_type = 0
        unplaced: List[str] = []
        # placement stickiness: keep a job where it already runs if the new
        # grant still covers it — avoids gratuitous checkpoint/migrate cycles
        # when the LP returns a different-but-equivalent optimum next round.
        if prev and not naive:
            for job in order:
                pa = prev.get(job.job_id)
                if not pa:
                    continue
                need = sum(c for _, _, c in pa)
                if need != job.workers:
                    continue
                if all(user_budget[job.user, j] >= 0 for j, _, _ in pa):
                    ok = all(free[j][h] >= c for j, h, c in pa) and all(
                        user_budget[job.user, j] >= sum(c2 for j2, _, c2 in pa if j2 == j)
                        for j in sorted({j for j, _, _ in pa}))
                    if ok:
                        for j, h, c in pa:
                            free[j][h] -= c
                            user_budget[job.user, j] -= c
                        assignments[job.job_id] = list(pa)
                        types_used = {j for j, _, _ in pa}
                        hosts_used = {(j, h) for j, h, _ in pa}
                        if len(hosts_used) > 1:
                            cross_host += 1
                        if len(types_used) > 1:
                            cross_type += job.workers
        for job in order:
            if job.job_id in assignments:
                continue
            need = job.workers
            if user_budget[job.user].sum() < need:
                unplaced.append(job.job_id)
                continue
            placed: List[Tuple[int, int, int]] = []
            types_used = set()
            hosts_used = set()
            job_type_order = type_order
            if not naive:
                # straggler avoidance (§4.4/§6.3.1): place the whole job in a
                # single device type when any granted type can hold it —
                # fastest such type first; only mix types as a last resort.
                whole_types = [j for j in type_order
                               if int(user_budget[job.user, j]) >= need
                               and int(free[j].sum()) >= need]
                if whole_types:
                    job_type_order = whole_types + [j for j in type_order
                                                    if j not in whole_types]
            for j in job_type_order:
                if need <= 0:
                    break
                avail_j = int(user_budget[job.user, j])
                if avail_j <= 0:
                    continue
                if naive:
                    host_seq = list(range(len(free[j])))  # first-fit, no packing
                else:
                    # best-fit: host with the fewest free slots that still fits
                    host_order = np.argsort(free[j])
                    # first try to fit the whole job in one host
                    whole = [h for h in host_order if free[j][h] >= min(need, avail_j)]
                    host_seq = (whole + [h for h in host_order if h not in whole]) if whole else list(host_order)
                for h in host_seq:
                    if need <= 0 or avail_j <= 0:
                        break
                    take = int(min(free[j][h], avail_j, need))
                    if take <= 0:
                        continue
                    free[j][h] -= take
                    avail_j -= take
                    user_budget[job.user, j] -= take
                    need -= take
                    placed.append((j, int(h), take))
                    types_used.add(j)
                    hosts_used.add((j, int(h)))
            if need > 0:  # rollback
                for j, h, cnt in placed:
                    free[j][h] += cnt
                    user_budget[job.user, j] += cnt
                unplaced.append(job.job_id)
                continue
            assignments[job.job_id] = placed
            if len(hosts_used) > 1:
                cross_host += 1
            if len(types_used) > 1:
                cross_type += job.workers
        return PlacementResult(
            real=real,
            assignments=assignments,
            cross_host_jobs=cross_host,
            cross_type_workers=cross_type,
            unplaced_jobs=unplaced,
        )


def long_run_share_error(placer_history: Sequence[Array], ideal: Array) -> float:
    """Mean |time-averaged real - ideal| — rounding convergence metric."""
    avg = np.mean(np.stack(placer_history, axis=0), axis=0)
    return float(np.mean(np.abs(avg - ideal)))
