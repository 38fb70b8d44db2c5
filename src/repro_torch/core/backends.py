"""Solver backend registry: one strategy layer for every OEF/baseline program.

Before this module, backend selection was ad-hoc ``backend=`` plumbing
duplicated across ``core/oef.py``, ``service/scheduler.py`` and
``service/__main__.py``, and each call site re-implemented the "try the fast
tier, fall back to the LP" dance with its own ``meta`` stamping. The registry
centralizes all of it:

  - :func:`register_backend` declares a ``(program, backend)`` implementation
    — which *program* it solves (``oef-noncoop``, ``oef-coop``, ...), which
    *instance class* it is exact on (``any`` | ``piecewise-monge``), and its
    *fallback* backend for instances it declines;
  - :func:`resolve_backend` looks an implementation up;
  - :func:`dispatch` runs the chain: a backend that cannot handle an instance
    raises :class:`BackendError` and dispatch falls through to its declared
    fallback, recording ``meta["backend"]`` / ``meta["fallback_from"]`` /
    ``meta["fallback_reason"]`` in exactly one place.

Every registered solver must be an ``@audited_solver`` entry point (enforced
here at registration time and statically by analysis rule C304), so the
property-audit surface stays uniform no matter which tier produced the
allocation.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Tuple

from ..kernels import KernelError
from ..obs import clock as _obs_clock
from ..obs import trace as _obs_trace
from .types import Allocation


class BackendError(RuntimeError):
    """A backend declined an instance (off-class, or it failed to converge).

    Raising this from a registered solver is the fallback protocol:
    :func:`dispatch` catches it and retries on the backend's declared
    fallback. Anything else (bad input, missing dependency) should raise
    ``ValueError`` / ``RuntimeError`` as usual and will propagate — unless
    the caller opted into ``dispatch(..., failsafe=True)``, which converts
    unexpected exceptions into declines so the chain keeps walking.

    ``transient=True`` marks an error worth retrying on the *same* backend
    (a numerical blip, an injected chaos fault) before falling through;
    :func:`dispatch` honours it when ``max_retries > 0``.
    """

    def __init__(self, message: str = "", *, transient: bool = False) -> None:
        super().__init__(message)
        self.transient = transient


class SolveTimeout(BackendError):
    """A solve exceeded its wall-clock budget (or a chaos-injected one).

    Subclasses :class:`BackendError` so the fallback chain handles it, but
    dispatch additionally stamps ``meta["degraded"]`` on the answer that a
    lower tier eventually produced: a timeout is a guardrail event, not a
    routine off-class decline.
    """


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered ``(program, backend)`` implementation."""

    program: str
    backend: str
    solver: Callable[..., Allocation]
    #: instance family the solver is exact on: "any", or "piecewise-monge"
    #: (the staircase class of ``oef.classify_staircase``).
    instance_class: str = "any"
    #: backend name (same program) to fall through to on BackendError.
    fallback: Optional[str] = None
    #: keyword names the solver accepts — dispatch() filters its kwargs so
    #: one call site can pass the union (tau_hint, method, device, ...).
    accepts: Tuple[str, ...] = ()


_REGISTRY: Dict[Tuple[str, str], BackendSpec] = {}
_DEFAULT: Dict[str, str] = {}

#: dispatch-level fault-injection / observation hooks. Each hook is called
#: as ``hook(program, backend, W, m)`` immediately before every solve
#: attempt; a hook that raises :class:`BackendError` (or a subclass) makes
#: that attempt decline exactly as if the solver itself had, so a chaos
#: harness can inject deterministic faults without monkey-patching any
#: solver.
_DISPATCH_HOOKS: List[Callable[[str, str, object, object], None]] = []


def register_backend(
    program: str,
    backend: str,
    solver: Callable[..., Allocation],
    *,
    instance_class: str = "any",
    fallback: Optional[str] = None,
    default: bool = False,
) -> Callable[..., Allocation]:
    """Register ``solver`` as the ``backend`` implementation of ``program``.

    ``solver`` must carry ``@audited_solver`` (analysis rule C304 checks the
    same contract statically); ``fallback`` names another backend of the same
    program to try when this one raises :class:`BackendError`; ``default``
    marks the program's default chain entry. Returns ``solver`` unchanged so
    it can be used as a post-decorator.
    """
    if not getattr(solver, "__audited_solver__", False):
        raise ValueError(
            f"backend {backend!r} for program {program!r}: solver "
            f"{getattr(solver, '__name__', solver)!r} is not an "
            f"@audited_solver entry point (rule C304)")
    params = inspect.signature(solver).parameters
    accepts = tuple(
        p.name for p in params.values()
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY))
    _REGISTRY[(program, backend)] = BackendSpec(
        program=program, backend=backend, solver=solver,
        instance_class=instance_class, fallback=fallback, accepts=accepts)
    if default or program not in _DEFAULT:
        _DEFAULT[program] = backend
    return solver


def unregister_backend(program: str, backend: str,
                       *, new_default: Optional[str] = None) -> None:
    """Remove a registered implementation (chaos-harness teardown).

    When the removed backend was the program's default, ``new_default`` (or
    any surviving backend, sorted-first) takes over so the program never
    loses its chain.
    """
    _REGISTRY.pop((program, backend), None)
    if _DEFAULT.get(program) == backend:
        if new_default is not None:
            _DEFAULT[program] = new_default
        else:
            survivors = backends_for(program)
            if survivors:
                _DEFAULT[program] = survivors[0]
            else:
                _DEFAULT.pop(program, None)


def add_dispatch_hook(hook: Callable[[str, str, object, object], None]) -> None:
    """Install a pre-attempt dispatch hook (see ``_DISPATCH_HOOKS``)."""
    _DISPATCH_HOOKS.append(hook)


def remove_dispatch_hook(hook: Callable[[str, str, object, object], None]) -> None:
    """Remove a previously installed dispatch hook (no-op when absent)."""
    try:
        _DISPATCH_HOOKS.remove(hook)
    except ValueError:
        pass


def resolve_backend(program: str, backend: Optional[str] = None) -> BackendSpec:
    """Look up a registered implementation."""
    if backend is None:
        backend = default_backend(program)
    spec = _REGISTRY.get((program, backend))
    if spec is None:
        raise ValueError(
            f"no backend {backend!r} registered for program {program!r}; "
            f"available: {backends_for(program)}")
    return spec


def default_backend(program: str) -> str:
    if program not in _DEFAULT:
        raise ValueError(
            f"unknown program {program!r}; known: {sorted(programs())}")
    return _DEFAULT[program]


def programs() -> List[str]:
    """All program names with at least one registered backend."""
    return sorted({p for p, _ in _REGISTRY})


def backends_for(program: str) -> List[str]:
    """Backend names registered for ``program``."""
    return sorted({b for p, b in _REGISTRY if p == program})


def backend_names() -> List[str]:
    """Every backend name any program can route to (CLI ``--backend`` choices)."""
    return sorted({b for _, b in _REGISTRY})


def dispatch(program: str, W, m, *, backend: Optional[str] = None,
             max_retries: int = 0, time_budget_s: Optional[float] = None,
             failsafe: bool = False, **kwargs) -> Allocation:
    """Solve ``program`` on ``(W, m)`` via the backend chain.

    Starts at ``backend`` (or the program default) and walks declared
    fallbacks on :class:`BackendError`. Extra keyword arguments are filtered
    per backend by the registered signature, so callers can pass the union
    (``tau_hint=`` and ``device=`` for the water-filling tiers, ``method=``
    for the LPs, ...).

    Guardrails (the solver escalation ladder the online service relies on):

    - ``max_retries`` — a :class:`BackendError` flagged ``transient`` is
      retried on the *same* backend up to this many times before falling
      through. Retries are immediate and deterministic: the control plane
      runs in virtual time, so the re-solve throttle is the backoff — a wall
      sleep here would only add decision latency. The retry count lands in
      ``meta["retries"]``.
    - ``time_budget_s`` — per-attempt wall-clock budget, checked after the
      attempt (Python solves cannot be preempted). An over-budget answer is
      discarded and the chain falls through as on :class:`SolveTimeout`.
      Wall-clock dependent, hence opt-in and off in deterministic replays;
      chaos runs inject *virtual* timeouts through hooks instead.
    - ``failsafe`` — any non-``BackendError`` exception from a backend is
      converted into a decline so the chain keeps walking (a crash of a
      host solver -> LP). Only the chain running dry still raises, and then
      always as :class:`BackendError`, so callers have a single exception
      to floor on. A :class:`~repro_torch.kernels.KernelError` (a kernel
      that did not build, load or launch, or a fault on the card) is never
      converted: it propagates, so a broken card path cannot hand its work
      to a CPU solver unseen.

    The returned allocation's ``meta`` is stamped here — the single place
    backend attribution lives: ``meta["backend"]`` is the tier that actually
    produced the answer; after a fallback ``meta["fallback_from"]`` /
    ``meta["fallback_reason"]`` describe the first declined attempt, and
    ``meta["degraded"]`` is set when a *guardrail* engaged (timeout,
    unexpected exception, or a transient error that exhausted its retries) —
    routine off-class declines do not count as degradation.
    """
    spec = resolve_backend(program, backend)
    attempts: List[Tuple[str, str]] = []
    retries_left = max_retries
    total_retries = 0
    degraded = False
    attempt_no = 0
    with _obs_trace.span("dispatch", "core", program=program):
        while True:
            attempt_no += 1
            try:
                with _obs_trace.span("backend/" + spec.backend, "core",
                                     attempt=attempt_no):
                    for hook in list(_DISPATCH_HOOKS):
                        hook(program, spec.backend, W, m)
                    t0 = _obs_clock.wall()
                    alloc = spec.solver(
                        W, m,
                        **{k: v for k, v in kwargs.items()
                           if k in spec.accepts})
                    if time_budget_s is not None:
                        elapsed = _obs_clock.wall() - t0
                        if elapsed > time_budget_s:
                            raise SolveTimeout(
                                f"backend {spec.backend!r} took {elapsed:.3f}s "
                                f"(budget {time_budget_s:.3f}s)")
            except BackendError as e:
                if e.transient and retries_left > 0:
                    retries_left -= 1
                    total_retries += 1
                    _obs_trace.instant("dispatch/retry", "core",
                                       backend=spec.backend)
                    continue
                if isinstance(e, SolveTimeout) or (e.transient and max_retries > 0):
                    degraded = True  # guardrail event, not a routine decline
                    _obs_trace.instant(
                        "guardrail/timeout" if isinstance(e, SolveTimeout)
                        else "guardrail/retries_exhausted",
                        "guardrail", backend=spec.backend)
                attempts.append((spec.backend, str(e)))
                if spec.fallback is None:
                    raise BackendError(
                        f"program {program!r}: every backend in the chain "
                        f"declined: {attempts}") from e
                _obs_trace.instant("dispatch/fallback", "core",
                                   src=spec.backend, dst=spec.fallback)
                spec = resolve_backend(program, spec.fallback)
                retries_left = max_retries
                continue
            except KernelError:
                raise
            except Exception as e:  # repro guardrail: escalate instead of raising
                if not failsafe:
                    raise
                degraded = True
                _obs_trace.instant("guardrail/failsafe", "guardrail",
                                   backend=spec.backend,
                                   error=type(e).__name__)
                attempts.append((spec.backend, f"{type(e).__name__}: {e}"))
                if spec.fallback is None:
                    raise BackendError(
                        f"program {program!r}: every backend in the chain "
                        f"failed: {attempts}") from e
                spec = resolve_backend(program, spec.fallback)
                retries_left = max_retries
                continue
            alloc.meta["backend"] = spec.backend
            if attempts:
                alloc.meta["fallback_from"] = attempts[0][0]
                alloc.meta["fallback_reason"] = attempts[0][1]
            if total_retries:
                alloc.meta["retries"] = total_retries
            if degraded:
                alloc.meta["degraded"] = True
            return alloc
