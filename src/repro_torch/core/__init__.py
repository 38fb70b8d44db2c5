"""OEF core: the paper's resource-allocation framework.

Public API:
  - types: ClusterSpec, Tenant, JobTypeProfile, Allocation, TPU_FLEET
  - oef: solve_noncoop / solve_coop / solve_noncoop_fast / evaluate_tenants
  - torch_solve: the non-cooperative water-filling tier on the GPU
  - torch_coop: the cooperative primal–dual tier on the GPU (registered as
    the ``"torch"`` backend of ``oef-coop`` on import)
  - baselines: solve_maxmin / solve_gavel / solve_gandiva_fair
  - properties: fairness property checkers
  - placement: RoundingPlacer
  - profiler: ProfilingAgent, WorkloadCost, paper workloads
  - simulator: ClusterSimulator
"""
from .types import (  # noqa: F401
    Allocation,
    ClusterSpec,
    DeviceTypeSpec,
    JobTypeProfile,
    Tenant,
    TPU_FLEET,
    monotone_types,
    normalize_speedup_matrix,
    validate_speedup_matrix,
)
from .lp import LPError, LPResult, solve_lp  # noqa: F401
from .backends import (  # noqa: F401
    BackendError,
    BackendSpec,
    dispatch,
    register_backend,
    resolve_backend,
)
from .oef import (  # noqa: F401
    TenantAllocation,
    allocation_reusable,
    classify_staircase,
    evaluate_tenants,
    expand_virtual_users,
    solve_coop,
    solve_efficiency_only,
    solve_incremental,
    solve_noncoop,
    solve_noncoop_fast,
    solve_noncoop_waterfill,
    solve_noncoop_waterfill_torch,
)
from .baselines import solve_gandiva_fair, solve_gavel, solve_maxmin  # noqa: F401
from .properties import (  # noqa: F401
    adjacency_ok,
    envy_matrix,
    is_envy_free,
    is_pareto_efficient,
    is_sharing_incentive,
    property_report,
    strategy_proofness_probe,
    total_efficiency,
)
from .placement import JobRequest, PlacementResult, RoundingPlacer  # noqa: F401
from .profiler import (  # noqa: F401
    PAPER_WORKLOAD_SPEEDUPS,
    ProfilingAgent,
    WorkloadCost,
    paper_job_type,
    step_time,
)
from .simulator import (  # noqa: F401
    ClusterSimulator,
    POLICIES,
    SimJob,
    SimResult,
    SimTenant,
    make_synthetic_tenants,
)
from .torch_coop import solve_coop_batch, solve_coop_pd  # noqa: F401,E402
