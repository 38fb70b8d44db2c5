"""repro_torch — the OEF system on PyTorch and CUDA, beside the JAX package.

Same layout and module names as ``repro``: ``core`` (OEF solvers, the
backend registry, the GPU water-filling tier ``core.torch_solve``),
``kernels`` (hand-written CUDA kernels with their plain torch versions),
``service`` (the online event-driven scheduler and its CLI) and ``obs``
(tracing and metrics). The package imports torch, numpy and scipy, never
jax and nothing of ``repro``; ``interop`` carries plain data across for
tests that run both.
"""
