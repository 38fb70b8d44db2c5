"""The port's job-level elastic OEF (paper §8) vs the JAX package's copy.

``repro_torch.core.elastic`` is a copy of ``repro.core.elastic`` (numpy over
the LP); on the same instances both must give the same answer exactly: the
allocation of every job, every tenant's utility, the total, and the two
helpers ``segment_utility`` and ``rigid_equivalent``. The instances are
``tests/test_elastic.py``'s, and its property test's seeds 0-19.
"""
import numpy as np
import pytest

from repro.core import elastic as jelastic
from repro_torch.core import elastic
from torch_threads import one_thread

one_thread()


def _tenants(mod, spec):
    return [mod.ElasticTenant(name, tuple(mod.ElasticJob(*job) for job in jobs))
            for name, jobs in spec]


def _seeded(seed):
    """``tests/test_elastic.py::test_elastic_capacity_and_segments``' instance."""
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(2, 4)), int(rng.integers(2, 3))
    m = rng.integers(2, 6, k).astype(float)
    spec = []
    for i in range(n):
        speed = tuple(np.cumsum(rng.uniform(0.2, 1.0, k)) / 1.0)
        spec.append((f"u{i}", ((f"j{i}", speed, int(rng.integers(2, 5)),
                                float(rng.uniform(0.5, 1.0))),)))
    return spec, m


W3 = np.array([[1.0, 2.0], [1.0, 3.0], [1.0, 4.0]])
INSTANCES = {
    "linear": ([(f"u{i}", ((f"j{i}", tuple(W3[i]), 8, 1.0),)) for i in range(3)],
               np.array([1.0, 1.0])),
    "concave": ([("fast", (("f", (1.0, 4.0), 4, 0.3),)),
                 ("slow", (("s", (1.0, 3.0), 4, 0.3),))], np.array([0.0, 4.0])),
    "rigid": ([("a", (("a0", (1.0, 2.0), 4, 0.8),)),
               ("b", (("b0", (1.0, 3.5), 4, 0.8),))], np.array([3.0, 3.0])),
    "conservative_ef": ([("a", (("a0", (1.0, 1.8), 4, 0.7),)),
                         ("b", (("b0", (1.0, 3.0), 4, 0.7),))], np.array([2.0, 4.0])),
    "two_jobs_weighted": ([("a", (("a0", (1.0, 2.0), 3, 0.9), ("a1", (1.0, 1.5), 2, 0.6))),
                           ("b", (("b0", (1.0, 3.0), 4, 0.8),))], np.array([3.0, 2.0])),
}
INSTANCES.update({f"seed{s}": _seeded(s) for s in range(20)})


def _same(a, b):
    assert list(a.X) == list(b.X)
    for t in a.X:
        assert list(a.X[t]) == list(b.X[t])
        for j in a.X[t]:
            np.testing.assert_array_equal(a.X[t][j], b.X[t][j])
    assert a.utility == b.utility
    assert a.total_utility == b.total_utility


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("envy_free", (True, False))
def test_solve_elastic_coop_matches_jax_package(name, envy_free):
    spec, m = INSTANCES[name]
    got = elastic.solve_elastic_coop(_tenants(elastic, spec), m, envy_free=envy_free)
    ref = jelastic.solve_elastic_coop(_tenants(jelastic, spec), m, envy_free=envy_free)
    _same(got, ref)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_segment_utility_and_rigid_equivalent_match_jax_package(name):
    spec, m = INSTANCES[name]
    ours, theirs = _tenants(elastic, spec), _tenants(jelastic, spec)
    assert elastic.rigid_equivalent(ours, m) == jelastic.rigid_equivalent(theirs, m)
    got = elastic.solve_elastic_coop(ours, m)
    for t, t_ref in zip(ours, theirs):
        for s in got.X:
            bundle = sum(got.X[s].values())
            for job, job_ref in zip(t.jobs, t_ref.jobs):
                assert elastic.segment_utility(job, bundle) \
                    == jelastic.segment_utility(job_ref, bundle)
