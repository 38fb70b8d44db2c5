"""repro_torch — the OEF system on PyTorch and CUDA, beside the JAX package.

Same layout and module names as ``repro``: ``core`` (OEF solvers, the
backend registry, the GPU tiers ``core.torch_solve`` (water-filling) and
``core.torch_coop`` (cooperative primal–dual)),
``kernels`` (hand-written CUDA kernels with their plain torch versions),
``service`` (the online event-driven scheduler and its CLI), ``obs``
(tracing and metrics), and the workload stack for recurrentgemma-2b:
``configs``, ``models`` (layers, the training loss, prefill and greedy
decode), ``optim``, ``data``, ``checkpoint``, ``runtime`` (the train,
prefill and serve steps and the trainer), ``launch.serve`` and
``launch.train``.
The package imports torch, numpy and scipy, never jax and nothing of
``repro``; ``interop`` carries plain data across for tests that run both.
"""
