#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

Drives ``repro_torch`` (never the JAX package) in phases; any failed check
raises and the script exits non-zero:

1. build the water-filling, envy-gap, RG-LRU scan (forward and backward),
   flash attention, cross-entropy and sLSTM (forward and backward) kernels
   from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a``, one compiler process per source, all started
   together (``waterfill.cu`` also holds the fused solve, ``envy.cu`` the
   fused PD segment); ptxas must report no spill in either fused kernel;
2. hold the kernel against its plain torch version on the card, on seeded
   staircase instances (n_pad 8..8192, k 3 and 4, T 1 and 8) at
   atol = rtol = 1e-12, and time both at the service's shape (n_pad 1024,
   k 3, T 8);
3. the fused solve (one launch a solve: bracket, hint probe, multisection
   and allocation) against the unfused solve on the card (the same
   composition probing through the kernel of phase 2: tau bit for bit, X
   within 1e-12 * max(m)) and the plain solve on the CPU (1e-9), n_pad
   8..8192, k 3, 4 and 40, B 1 and 3, cold and warm; through the entry
   points at n = 1024, k = 3, cold and warm-started, against the CPU and
   the port's numpy greedy (see ``agree``), and a batch of three, one
   launch each; a solve of 16 lanes, more than the fused kernel carries,
   on the unfused route (one masses launch per probe); and its times: the kernel, one solve's execute span, the unfused
   solve as called and in a CUDA graph, the bound;
4. the online service at full size: 1024 tenants on 1024+1024+1024 devices,
   ``oef-noncoop`` on the ``torch`` backend on ``cuda``. Every solve must
   come from ``torch`` with no LP fallback, no degraded solve and no
   ``solver_floor``, the fused solve must have been launched exactly once
   per solved instance and no other kernel at all, every solved instance
   must agree with the CPU solve and the numpy greedy, and a second replay
   must repeat the first report bit for bit (less its wall-clock latency
   fields);
5. 128 tenants on 128x3 devices, replayed with the ``numpy`` backend, the
   ``torch`` backend on the card and the ``torch`` backend on the CPU (the
   plain version). The card and CPU replays must match as the JAX tier's
   replay test matches numpy, and every instance the card solved must agree
   with the CPU solve and the numpy greedy. The numpy replay is held to the
   card's within ``NUMPY_REL`` on solves, finished jobs, events and total
   tenant throughput, not to the same decisions: identical tenants get shares that differ
   by ~1e-10 between the two solvers, which flips largest-remainder rounding
   ties (the JAX tier's replay departs from numpy at this size in the same
   way);
6. hold the envy-gap kernel against its plain torch version on the card at
   G in {8, 64, 512, 4096}, k in {3, 4}, B in {1, 3} (atol = rtol = 1e-12),
   and time it at (G 8, k 3), the service's shape, and (G 4096, k 3):
   device time by CUDA-graph replay, wrapper call time, the plain version
   and the nearest library form (``torch.addmm``); then the fused PD
   segment against the stepwise segment on the card (atol 1e-12) at G in
   {8, 32, PD_FUSED_MAX_G}, k in {3, 4}, B in {1, 3}, from a cold and a
   warm state, a second launch identical bit for bit, and its times at
   G 8 and PD_FUSED_MAX_G: the kernel, the wrapper call, the stepwise
   segment as called and in a CUDA graph, the bound;
7. the cooperative solve tier on the card, on 256-tenant catalog instances
   and a 32-tenant instance of distinct rows, against the same solve on the
   CPU (same ``pd_iters`` and ``crossover``, objective within 1e-9
   relative, X within 1e-8 * max(m)) and the LP (certificate gap and envy
   within 1e-6), with the launches of each route: one fused launch per
   segment up to PD_FUSED_MAX_G groups, one envy launch per PD iteration
   above; the batch API on three instances against the CPU; and 64- and
   128-tenant distinct instances, which the tier does not certify within a
   cut budget on either device (the JAX tier neither), spending exactly
   that budget, on the fused route and on the stepwise one;
8. the service with the cooperative policy: 256 tenants on 256x3 devices,
   ``oef-coop`` on the ``torch`` backend on ``cuda``, the JAX package's
   largest coop-jax benchmark cell. Every solve from ``torch``, no LP
   fallback, no degraded solve, no ``solver_floor``, one fused launch per
   PD segment the solves report (at least one) and no other kernel, and a
   second replay identical bit for bit;
9. 64 tenants on 64x3 devices, ``oef-coop``, replayed with ``torch`` on the
   card, ``torch`` on the CPU and ``numpy`` (the LP): card and CPU make the
   same decisions (as in phase 5), the LP replay is within ``NUMPY_REL``;
10. hold the RG-LRU forward kernels against their plain torch version on
    the card, bit for bit (``torch.equal``), through ``rglru_scan`` on the
    route ``_route`` names (one launch per call, counted per route) and,
    where that is the TMA kernel, through the direct kernel too: the
    model's training and prefill shapes in float32 and the prefill shape in
    bf16, the JAX kernel test's range, S = 1, S below one tile, one tile
    +- 1 and 4097, D = 32, ragged 32-feature columns (2568, 2564), bf16
    with D % 8 == 0 and != 0, float32 D = 97 and misaligned views (the
    last three on the direct kernel), nonzero ``h0``; ptxas's registers
    and spills of every RG-LRU kernel (no spill) and a TMA load (UTMALDG)
    in each TMA kernel's SASS; and both kernels' times at (2, 2048, 2560)
    and (8, 2048, 2560) in float32 and bf16: device time by CUDA-graph
    replay, wrapper call (the TMA one encodes its tensor maps on the
    host), share of the byte bound; at the prefill shape also the plain
    version and the nearest library form (the private
    ``torch._higher_order_ops.associative_scan``, where the card's torch
    has it);
11. serve recurrentgemma-2b at full width (``get_config``, weights from a
    seeded ``torch.Generator``, bf16 compute, TF32 off): prefill 8 prompts
    of 2048 tokens, then 32 greedy decode steps, through
    ``repro_torch.launch.serve.generate``. Exactly 18 kernel launches per
    prefill (one per RG-LRU layer), all on the TMA kernel, and none in
    decode, finite logits, and
    a second run repeats the tokens and logits bit for bit; prefill and
    decode rates, the kernel's share of prefill, peak memory and the top
    device operations of one prefill and of ``DECODE_PROFILE_STEPS``
    decode steps (``torch.profiler``), with the device's idle share of
    each; no launch
    of any other kernel (the model calls neither flash attention nor the
    cross-entropy);
12. the card against the CPU at full width and cut depth (``n_layers=5``:
    one unit and the two-layer tail), B = 1, S = 256, the same weights
    (drawn on the card and copied to the CPU; the card-vs-CPU phases all
    do so): in float32 the prefill logits, the final-normed hidden state
    at every position (the full logits' input) and the last decode step's
    logits within 1e-4 of their max and 8 greedy decode tokens identical;
    in bf16 within 5e-2;
13. hold the flash attention kernels against their plain version through
    ``ops.flash_attention`` / ``flash_attention_gqa`` (1e-5 in float32,
    2e-2 in bf16), one launch per op call on the path the routing rule
    names (bf16 with D % 8 == 0 and 16-byte aligned operands on the
    tensor-core kernel, the rest on the CUDA-core kernel), counted per path:
    the JAX kernel tests' shapes in both dtypes, causal and not, windows
    64-256, GQA, Sq != Sk, rows that see no key, D = 256, ragged tiles and
    D 48 / 80, and the tensor-core kernel's edges (tiles on the diagonal at
    S = 2048, a window edge inside a tile, GQA 10/1, ragged Sk, D = 32, a
    misaligned bf16 view and D = 36, which take the CUDA-core kernel); an
    input that requires grad raises in flash attention and the
    cross-entropy, and grad flows through the RG-LRU scan's forward and
    backward kernels; the tensor-core kernel's SASS holds HGMMA and
    UTMALDG (ptxas's registers and spills printed); then the full-width
    shapes of ``FLASH_FULL`` (the three that phase 30's yi-9b and gemma3-4b
    blocked prefills give the kernel, phase 38's arctic-480b one (GQA 7),
    recurrentgemma-2b's and gemma3-4b's at S 4096) held to the plain version and to
    ``scaled_dot_product_attention``, a second launch identical bit for
    bit, and timed: device time by CUDA-graph replay, op call, TFLOP/s,
    share of the bound, plain version, SDPA; and the float32 path at
    yi-9b's shape;
14. the same for the cross-entropy kernel through ``ops.softmax_xent``
    (atol 1e-4, rtol 1e-5): the JAX kernel tests' shapes, a prime V,
    N = 1, V = 1, unaligned float32 rows, int64 targets, targets -1 and V (the loss is the logsumexp);
    then one training-loss chunk of 4096 tokens over gemma3-4b's 262,144
    and recurrentgemma-2b's 256,000 vocab, timed against the plain version,
    ``F.cross_entropy`` and the byte bound;
15. hold the RG-LRU backward kernels (the reverse scan of the training
    path) against their plain version on the card, bit for bit, on the
    route ``_route`` names and, where that is the TMA kernel, on the direct
    one too: the training shape (2, 2048, 2560), the JAX kernel test's
    range, ragged D (2568, 2564), S = 1, 17, one tile +- 1 and 4097,
    D = 32, float32 D = 97 and a misaligned view (the direct kernel),
    nonzero ``h0``; grad through ``ops.rglru_scan`` (both kernels) against
    autograd of the plain forward (atol 1e-5, rtol 1e-4); and both
    kernels' times at the training shape: CUDA-graph device time, wrapper
    call, share of the byte bound, the plain version and the private
    ``associative_scan`` run in reverse;
16. train recurrentgemma-2b at full width (``get_config``: bf16 compute,
    float32 masters, ``remat="full"``, ``logits_chunk=512``, AdamW) through
    ``repro_torch.runtime.Trainer``, the trainer of ``launch.train``: a
    global batch of 2 x 2048 seeded tokens, 3 steps, TF32 off. Exactly 34
    forward (18 layers and the 16 recomputed in the units) and 18 backward
    RG-LRU launches a step, all on the TMA kernels, and no launch of any
    other kernel, finite
    losses, a second run's first loss identical bit for bit; step times,
    tokens/s, peak memory, ``costs.model_flops`` a step and its share of
    the bf16 tensor-core peak, and the top device operations of one
    profiled step;
17. one training step on the card against the CPU at full width and cut
    depth (``n_layers=5``, B 1, S 128 (``TRAIN_CUT_S``; 256 before PR 27),
    float32, the same weights): the loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its max |g|,
    and one AdamW update on the card's gradients within 1e-6 of each
    leaf's max |p| on the card and on the CPU;
18. serve qwen2-1.5b and gemma3-4b at full width (``get_config``, full
    attention with the QKV bias; gemma3's 5:1 sliding and full pattern
    with its four-layer sliding tail) through ``launch.serve.generate``:
    8 prompts of 2048 tokens, 32 greedy steps, bf16, TF32 off, seeded.
    No launch of any kernel wrapper (``repro_torch.kernels.wrappers``:
    the JAX model runs no Pallas kernel on these paths), finite logits of
    shape (8, 1, padded_vocab), tokens in [0, vocab), a second run
    identical bit for bit; prefill and decode rates, peak memory and the
    top device operations of one profiled prefill and of the profiled
    decode steps, with the device's idle share of each;
19. each of them on the card against the CPU at full width and cut depth
    (qwen2 ``n_layers=3``, S 256; gemma3 ``n_layers=8``, one unit and a
    two-layer sliding tail, S 1152 past its 1024 window), B 1, 8 greedy
    steps, the same weights: prefill and last-decode logits within 1e-4
    (float32) and 5e-2 (bf16) of max |logits|, float32 tokens identical;
20. train each at full width through ``runtime.Trainer``: qwen2-1.5b at
    8 x 2048 (the JAX launcher's default batch), gemma3-4b at 2 x 2048 in
    its two microbatches; 3 AdamW steps, seeded Zipf tokens, TF32 off. No
    kernel launch, finite losses, a second run's first loss identical bit
    for bit; step times, tokens/s, peak memory, ``costs.model_flops`` a
    step and its share of the bf16 tensor-core peak, the top device
    operations of one profiled step;
21. one float32 training step of each on the card against the CPU at
    phase 19's cut depths and lengths (qwen2-1.5b at S 128 since PR 27,
    ``TRAIN_CUT_S``): the loss within 1e-5 relative,
    every gradient leaf (the QKV biases included) within 1e-4 of its max
    |g|, one AdamW update within 1e-6 of max |p|;
22. serve xlstm-350m at full width and depth (12 (mLSTM, sLSTM) units, no
    FFN) as phase 18 serves the others: exactly one sLSTM scan launch a
    layer a prefill (12) and a decode step (12 x 32), no other kernel;
23. xlstm-350m on the card against the CPU as phase 19, at
    ``n_layers=4`` (two units) and S 600 (three mLSTM chunks, the last
    padded);
24. train xlstm-350m at full width and depth as phase 20, 8 x 2048,
    ``logits_chunk=512``, 3 steps: exactly 24 sLSTM forward launches (12
    layers and their recompute under ``remat="full"``) and 12 backward a
    step; the model-FLOP share by ``costs.model_flops`` and by 6 x the
    model's real parameter count;
25. one float32 training step of xlstm-350m on the card against the CPU
    at phase 23's cut depth, held as phase 21;
26. OEF-scheduled multi-tenant training through
    ``repro_torch.launch.train.run_scheduled`` (the JAX launcher's
    simulated TPU fleet, smoke models, 8 x 128): ``oef-coop`` over
    qwen2-1.5b, gemma3-4b and xlstm-350m for 3 rounds, then ``oef-noncoop``
    over recurrentgemma-2b and qwen2-1.5b for 2. The shares, grants and
    steps equal ``schedule_rounds``' on the host, every loss is finite,
    each wrapper's launches are exact (recurrentgemma-2b's steps x its
    RG-LRU forward and backward launches a step, xlstm-350m's x its sLSTM
    ones, none for the others);
    walls per round and tenant, steps/s;
27. the chaos engine on the non-coop torch tier: ``standard_plan(0)``
    merged into phase 5's 128-tenant trace, replayed on the card and on
    the CPU with the engine on the ``torch`` chain (same decisions, same
    fault summary; the CPU run's ladder, LP answers and degraded solves,
    must be the plan's crashes and timeouts), then into phase 4's
    1024-tenant trace (``until=600``), traced with metrics: every planned
    solver fault fires, the ladder is the CPU run's, ``waterfill_solve``
    launches once per torch attempt that got past the wrapper and no other
    kernel runs; ``obs.report`` reads the run's trace and metrics files
    back and lists the ``resolve;solve`` and ``resolve;placement`` stages;
28. the journal on the card, ``oef-coop``: a 128-tenant trace (phase 8's
    256 before PR 27) with
    ``tests/test_chaos.py``'s trace-level chaos, replayed plain and
    journaled (the same report), killed at the median of its distinct
    event times and resumed by ``resume_scheduler(..., device="cuda")``:
    the uninterrupted report bit for bit, and the ``pd_segment`` launches
    of the killed and resumed halves, less the journal tail the resume
    re-ran, add up to the uninterrupted run's;
29. the same for ``oef-noncoop`` at phase 5's 128 tenants, with
    ``waterfill_solve``;
30. serve yi-9b (untied head), phi4-mini-3.8b and phi-3-vision-4.2b
    (prompts as embeddings, decode on tokens) at full width and depth as
    phase 18 (no launch), then yi-9b and gemma3-4b on
    ``attention_impl="blocked"``: one flash launch per layer a prefill
    (48 / 34), all on the tensor-core kernel, none in decode; yi-9b's
    blocked prefill logits, and its final-normed hidden state at every
    position, within 5e-2 of their max in its xla run on the same weights,
    the two prefill times a pair; gemma3-4b's sliding layers hand the
    kernel their window;
31. card against CPU as phase 19 (``CUT_30``): yi-9b and phi-3-vision at
    3 layers, S 256, yi-9b blocked with tiles 64 / 128, gemma3-4b blocked
    at 8 layers, S 1152, tiles 128 / 384; the card runs the flash kernel,
    the CPU its twin. On the two blocked cases a planted fault (every flash
    call made non-causal) must fail the every-position check, and so must
    gemma3-4b's sliding layers without their window in float32 (in bf16
    that change is below rounding, and is recorded);
32. train at full width as phase 20 (``TRAIN_30``, 2 x 2048, 3 AdamW
    steps, ``logits_chunk=512``): phi4-mini-3.8b at full depth, yi-9b at
    12 of 48 layers on both attention paths, phi-3-vision at 16 of 32 on
    the pipeline's embeddings; no kernel launch (the blocked path trains
    on its twin);
33. one float32 training step card against CPU as phase 21
    (``TRAIN_CUT_30``: yi-9b blocked, with the head, and phi-3-vision);
34. serve whisper-tiny at full width and depth (4 non-causal encoder
    layers; 4 decoder layers, each cross-attending to the encoder's output;
    sinusoidal positions, no RoPE) as phase 18, on ``WHISPER_SERVE``: 8
    prompts of 1500 tokens beside 1500 bf16 frames (the audio frontend is a
    stub), 32 greedy steps against the cross caches. No launch of any
    kernel wrapper: whisper's attention is the grouped einsum (the JAX
    model takes the blocked path for neither the encoder nor
    cross-attention, and its config asks for ``xla``);
35. whisper-tiny on the card against the CPU at full width and depth as
    phase 19, B 1, 300 frames and 256 tokens (``WHISPER_CUT``: T != S), in
    float32 and bf16: prefill and last-decode logits, the hidden state at
    every position and every layer's cross caches ``ck``, ``cv`` (of T
    frames) within 1e-4 / 5e-2, float32 greedy tokens identical;
36. train whisper-tiny at full width and depth as phase 20: 8 x 1500
    (frames and tokens), ``remat="full"`` (the decoder's units; the encoder
    runs once), fp32 logits (no ``logits_chunk``), 3 AdamW steps, TF32
    off, no kernel launch; the model-FLOP share by ``costs.model_flops``
    and by 6 x ``numel``;
37. one float32 training step of whisper-tiny card against CPU as phase 21,
    B 1, 256 frames and tokens: the encoder's gradient leaves included;
38. serve arctic-480b (128 experts, top-2, a dense SwiGLU residual; the
    sort-dispatched MoE layer) at full width and 2 of 35 layers as phase
    18 (``MOE_SERVE``; no launch on the xla path), with the share of
    (token, slot) assignments the capacity drops and the exact ties at the
    top-k boundary; then one prefill on ``attention_impl="blocked"`` on the
    same weights: 2 flash launches, both tensor-core; a second one routed
    as the xla run (``forced_routes``: the xla path rounds the scores to
    bf16, the kernel does not, and a near-tie routed another way moves a
    row by O(1)) within 5e-2 of the xla run's logits and hidden state at
    every position, its own routing's flips recorded; then a third flash
    prefill on its own routes and one on the twin
    ``blocked_attention_plain`` on the card (no launch) taking them: the
    twin's hidden state within 5e-2 of flash's at every position, its own
    routing's flips against flash's recorded by ``route_check``'s rule
    (flash rounds the probabilities to bf16 before P.V, the twin does not,
    so flips beyond 2 bf16 ulps of the router logits occur);
39. arctic-480b card against CPU as phase 19 at one layer with 16 experts
    (``MOE_CUT``), float32 and bf16, under the routing-flip rule
    (``card_cpu_routes``): on the card's MoE input the CPU may route a
    token to another set of experts only where the swapped experts' CPU
    router logits are within 2 bf16 ulps (float32: 1e-5 relative), on at
    most 5% of the rows, and a kept flag may move only behind such a flip;
    the CPU's compared runs take the card's routing, so the logits and the
    hidden state compare at every position; planted faults (gates not
    renormalised; the capacity ignored, where the CPU drops assignments)
    must fail. Then the whole 128-expert layer on the card, bf16 weights
    held in float32, B 1 x S 256: ``MoE`` against ``moe_plain`` within 1e-5
    of max |out| (the capacity drops; both faults fail), and again with the
    router's columns tied in threes, so that every token ties at the top-2
    boundary: the card's route equal to ``moe_plain``'s (lower index
    first);
40. serve kimi-k2-1t-a32b (384 experts, top-8, a shared expert, a dense
    first layer, head dim 112) at full width and 2 of 61 layers (the dense
    layer and one MoE layer) as phase 38, xla only;
41. kimi-k2-1t-a32b card against CPU as phase 39 at its two layers with 32
    experts (unnormalised gates are gated in float32 only: in bf16 they
    move the hidden state less than the tolerance, and are recorded);
42. train arctic-480b at full width and 1 of 35 layers (``MOE_TRAIN``:
    14.07 B parameters) through ``runtime.Trainer`` with
    ``TrainerConfig(optimizer="adafactor")``: bf16 masters and compute,
    ``remat="full"``, full logits (the config has no ``logits_chunk``),
    seeded Zipf tokens, S 2048, TF32 off, 3 steps at the largest global
    batch of 4 and 2 whose first step leaves ``FREE_GB`` free. No kernel
    launch, finite losses, a second run's first loss identical; step time,
    tokens/s, peak memory, the optimizer updates' share of a step, the
    model-FLOP share by ``costs.model_flops`` (active parameters) and by
    6 x ``numel`` (every expert), one profiled step's idle share;
43. one arctic-480b training step card against CPU at ``MOE_CUT``'s one
    layer, 16 experts, B 1, S 128 (half ``MOE_CUT``'s, since PR 27), in float32 (loss 1e-5, every gradient
    1e-4 of its max, one Adafactor update 1e-6 of max |p|) and at the
    config's bf16 masters and compute (loss one bf16 ulp, gradients
    ``BF16_GRAD_ULPS`` ulps of their max, Adafactor one ulp of each weight):
    the CPU takes the card's routes, flips are judged on the card's MoE
    input as in phase 39, the card's recompute routes as its forward, a
    second identical card step gives bit-equal gradients, and the planted
    faults (the aux term left out; the capacity ignored) must fail the
    gradient check; then arctic's MoE layer at full width with 32 float32
    experts: the gradients of x, the router, the experts and the dense
    residual through ``MoE`` against ``moe_plain`` within 1e-5 (the
    capacity drops assignments);
44. train kimi-k2-1t-a32b at full width, its dense prefix layer and one MoE
    layer (top-8, the shared expert, the capacity by the formula), the 384
    experts cut to the largest of 256, 192 and 128 that leaves
    ``FREE_GB`` free, B 2, as phase 42 (``logits_chunk`` 512);
45. kimi-k2-1t-a32b card against CPU as phase 43 at two layers, 32 experts,
    S 128 (unnormalised gates planted too, gated in float32 only), and its
    MoE layer's gradients against ``moe_plain`` with 32 float32 experts;
46. the example twins on the card: ``repro_torch.examples.quickstart``
    (the paper's 3x2 instance: the LP oracle against the device tiers within
    1e-9, exactly one fused water-filling launch a non-coop solve, the SP
    probe's 33 included, and one fused PD-segment launch a segment of the
    coop solve, nothing else, no fallback, the SP gain <= 1e-9, every
    property holds) and ``repro_torch.examples.online_service`` (its coop
    replay on the ``torch`` backend on the card against the same twin on
    the CPU in this call, decision for decision as phase 5 judges it, and
    the same last fairness audit; zero fallbacks, zero degraded solves, the
    replay's PD-segment launches at least its segments and no other kernel;
    the cross-validation within 1%);
47. the mesh on one card: a world-1 NCCL group and a 1x1 ``DeviceMesh``;
    qwen2-1.5b at full width and depth, AdamW, B 2 x 2048 (``MESH_TRAIN``),
    2 steps through ``Trainer(mesh=)`` (ZeRO-3 storage, parameters gathered
    at use) against the same 2 steps without a mesh on the card: step 1's
    loss bit for bit, the masters within 1e-6 of max |p| after step 2; both
    step walls, peak memory and a profiled step's idle share;
    ``ef_int8_compress`` of one backward's gradients (every leaf of the
    first unit and the final norm) on the card bit for bit the CPU's in
    ``q`` and ``scale``, and ``compressed_psum_tree`` over the NCCL group
    equal to ``ef_int8_decompress``; at
    ``MESH_RESIZE_LAYERS`` (2) layers the step-1 checkpoint written and
    ``resize`` to a 1-D mesh from it reproducing step 2 (its loss bit for
    bit, the masters within 1e-6); the group is destroyed at the end;
48. the compute split over the ``model`` axis on one card
    (``split_phase``): recurrentgemma-2b at full width and one pattern unit
    (rglru, rglru, sliding; ``SPLIT_TRAIN``), float32, ``remat="full"``,
    AdamW, B 2 x 2048, 2 steps, trained by this process without a mesh
    (and again in two microbatches: its spread under a reordering of its
    sums) and by two spawned processes that share the card as two gloo
    ranks of a (1, 2) ``("data", "model")`` mesh (NCCL refuses two ranks on
    one device): every rank's losses within 1e-5 relative and masters
    within 1e-6 of max |p| (or twice the reordered run's spread, where that
    is larger) of the meshless trainer's, every ``Block`` input (2, 1024,
    2560), each step's RG-LRU launches the meshless step's (4 forward, 2
    backward), all on the TMA kernels, no plain-version call; each rank's
    step walls, idle share and peak memory, and its collectives a step by
    kind and bytes.
50. the dry-run on the card (``dryrun_phase``, ``repro_torch.launch.dryrun``
    in a spawned process of its own, after 47-49, so that its fake process
    group never meets their groups): fake CUDA tensors, nothing allocated
    and no kernel launched, the kernels' fake forms counted. Phase 47's cell
    traced on a 1x1 fake mesh: its peak within ``DRYRUN_PEAK_TOL`` (10%) of
    phase 47's measured peak, and its roofline step beside the measured
    step; phase 48's train step and phase 49's prefill and decode traced
    at ranks 0 and 1 of a (1, 2) fake mesh: the collectives by kind (calls
    and input bytes) those of the real gloo steps, the RG-LRU fake forms a
    step phase 48's launches (forward and backward), the flash fake forms a
    prefill phase 49's calls; and the production cells (``DRYRUN_CELLS``,
    yi-9b's and xlstm-350m's ``train_4k`` on the ``(16, 16)`` fake mesh)
    traced to ``OK`` records, written to ``chiprun_out/dryrun_torch/``,
    xlstm-350m's with the sLSTM kernels' fake forms a step its launches
    (24 forward, 12 backward) and no launch;
51. hold the sLSTM kernels (``kernels/slstm.py``: the scan of the xLSTM's
    scalar-memory mixer in one cooperative launch, and its backward)
    against their plain versions on the card (``SLSTM_CASES``: xlstm-350m's
    prefill and training shape 8 x 2048 at d 1024, H 4; phase 26's smoke
    width; a decode step from a non-zero state; a ragged shape; a width
    with more groups of 8 features than the card has SMs; on the wide
    route, the xLSTM paper's 760M, 1.3B and 2.7B widths, a ragged wide
    shape and a decode step at 1.3B's), the
    forward within ``SLSTM_FWD_TOL`` and the backward within
    ``SLSTM_BWD_TOL`` of max |plain| (or twice the plain version's own
    card-vs-CPU spread), a second launch identical, grad through the op
    (``dr`` included) against autograd of the plain loop, a planted
    per-head gate layout failing the forward's gate, and both kernels'
    times (and per step of the scan, at xlstm-350m's shape and the smoke
    width: ``SLSTM_TIMED``) against the bound, the plain loop and the plain
    loop in a CUDA graph, and the wide route's at 1.3B's width
    (``SLSTM_WIDE_TIMED``, no plain loop); first the kernels' plan query
    over every d up to 8192 at H 1, 2, 4 and 8 on the card's SM count, 114
    and 132, which must refuse no width.

The order is not the numbers': the build, then the kernel phases 2, 3, 6,
10 and 13-15, each alone on the card (their times go into the kernels'
line); then phases 4, 5, 7-9 and 27-29, the online service's replays
(host-bound: the card sees a solve now and then), run in a spawned process
of their own (``SchedulerLane``), which prints its log when this process
joins it after phase 25, while this process runs phases 51 and 11-25 with
one CPU thread fewer (51's kernel times share the card with the lane's
occasional solves); the CPU half of each training step card against CPU (17, 21,
25, 33: the CPU's step, the comparisons, the CPU's AdamW update, on host
copies of the card's gradients and updated weights) runs on a thread of its
own (``Behind``) beside the card phase that follows, drained before the next
phase that computes on the CPU (33's two steps go before 30 and 32 for it);
the rest in order. Each phase says on stderr when it is done.

Prints each phase's seconds (``seconds by phase``; in ``chip_smoke.json``
``phase_s``: this process's, and the lane's own), the kernels' JSON line,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Details (flame summary of the second
full-size replay, per-phase numbers) go to ``chiprun_out/chip_smoke.json``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: FP64 and FP32 rates outside the tensor cores, which is what the kernels'
#: arithmetic runs on.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
#: the published H100 SXM FP64 rate of the tensor cores (NVIDIA data
#: sheet): the least time for a float64 matrix product's operations.
FP64_TC_FLOPS = 67e12
#: the published H100 SXM dense bf16 rate of the tensor cores (NVIDIA data
#: sheet): the least time for attention's products on bf16 inputs.
BF16_TC_FLOPS = 989e12

TOL = 1e-12      # kernel vs plain version (as the JAX kernel test)
PARITY = 1e-9    # solve on the card vs the same solve on the CPU
COOP_TOL = 1e-6  # coop tier vs the LP: certificate gap and envy
#: numpy replay vs the card replay at 128 tenants (phase 5): relative
#: difference allowed in solves, finished jobs, events and the tenants'
#: total throughput. (Mean JCT is not held: it averages over the jobs that
#: finish inside the horizon, and two jobs more or less move it by ~6%.)
NUMPY_REL = 0.05
#: card vs CPU prefill logits, max |diff| / max |logits| (phase 12): float32,
#: and bf16 (the bound tests/test_models.py holds prefill to)
CARD_CPU_F32, CARD_CPU_BF16 = 1e-4, 5e-2
#: flash attention kernel vs its plain version (phase 13), by dtype: the
#: tolerances the JAX package's flash tests hold the Pallas kernel to
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: cross-entropy kernel vs its plain version (phase 14), as the JAX test
XENT_ATOL, XENT_RTOL = 1e-4, 1e-5
#: the training cell of phase 16: global batch x sequence x RG-LRU width
TRAIN_SHAPE = (2, 2048, 2560)
#: the serving cell of phases 11 and 18: batch, prompt length, greedy steps
SERVE_SHAPE = (8, 2048, 32)
#: the training cells of phases 16 and 20, global batch x sequence:
#: recurrentgemma-2b at 2 (its fp32 state and B 8's logits chunks would not
#: fit at 8), qwen2-1.5b at the JAX launcher's default batch of 8, gemma3-4b
#: at 2 (its fp32 state alone is 62 GB), split into its ``microbatches=2``
TRAIN_CELLS = {"recurrentgemma-2b": TRAIN_SHAPE[:2], "qwen2-1.5b": (8, 2048),
               "gemma3-4b": (2, 2048), "xlstm-350m": (8, 2048),
               "phi4-mini-3.8b": (2, 2048), "yi-9b": (2, 2048),
               "phi-3-vision-4.2b": (2, 2048), "whisper-tiny": (8, 1500)}
#: the dense-attention tenants of phases 18-21, each with its cut depth and
#: prompt length for the card-vs-CPU phases 19 and 21 (qwen2-1.5b: 3 full
#: layers; gemma3-4b: one (5 sliding + 1 full) unit and a two-layer sliding
#: tail, with S past its 1024 window)
DENSE = (("qwen2-1.5b", 3, 256), ("gemma3-4b", 8, 1152))
#: the card-vs-CPU training steps' lengths where they are shorter than the
#: serving comparisons' (phases 17 and 21; the CPU's full-width float32
#: step is the cost, and the time limit took it from 256 positions in PR 27)
TRAIN_CUT_S = {"recurrentgemma-2b": 128, "qwen2-1.5b": 128}
#: xlstm-350m in phases 22-25: its cut depth (two (mLSTM, sLSTM) units) and
#: prompt length (three 256-position mLSTM chunks, the last one padded) for
#: the card-vs-CPU phases 23 and 25; phases 22 and 24 serve and train it
#: at full depth (the sLSTM on its kernels since phase 51 holds them)
XLSTM = ("xlstm-350m", 4, 600)
#: decode steps in the profiled decode of phases 11, 18, 22 and 30 (8 before
#: phases 30-33: the profiler took 13-25 s to record 8 full-width steps)
DECODE_PROFILE_STEPS = 2
#: phases 30-33: yi-9b (an untied head), phi4-mini-3.8b and phi-3-vision-4.2b
#: (prompts and training inputs as embeddings), and the blocked attention
#: path, which serves on the flash kernel
ARCHS_30 = ("yi-9b", "phi4-mini-3.8b", "phi-3-vision-4.2b")
#: the blocked path at cut depth (phases 31, 33): tiles of 64 / 128 over
#: yi-9b's 256 positions (several tiles, skipped pairs), and of 128 / 384
#: over gemma3-4b's 1152, past its 1024 window
BLOCKED_YI = {"attention_impl": "blocked", "attention_block_q": 64,
              "attention_block_kv": 128}
BLOCKED_GEMMA = {"attention_impl": "blocked", "attention_block_q": 128,
                 "attention_block_kv": 384}
#: phase 31, card against CPU at full width: (arch, n_layers, prompt length,
#: overrides). Cut for the script's time limit: phi4-mini-3.8b, whose path
#: (full attention, tied table) is yi-9b's xla path without the head
CUT_30 = (("yi-9b", 3, 256, {}), ("phi-3-vision-4.2b", 3, 256, {}),
          ("yi-9b", 3, 256, BLOCKED_YI), ("gemma3-4b", 8, 1152, BLOCKED_GEMMA))
#: phase 33, one float32 train step card against CPU: the head and the twin
#: on the card (yi-9b blocked) and the embeddings input (phi-3-vision). Cut
#: for the time limit: yi-9b xla (the same head; phase 21 holds the xla
#: attention's gradients), phi4-mini and gemma3-4b blocked (the twin's window
#: is held to JAX on the CPU, and on the card the twin is yi-9b's code)
TRAIN_CUT_30 = (CUT_30[2], CUT_30[1])
#: phase 32's training cells, 2 x 2048: (arch, n_layers (None: all),
#: overrides). phi4-mini at full depth (~61 GB of fp32 state); yi-9b at 12
#: of 48 layers (8.8 B params x 16 bytes would not fit one card; 12 layers
#: are ~2.6 B, ~42 GB), on both attention paths; phi-3-vision at 16 of 32
TRAIN_30 = (("phi4-mini-3.8b", None, {}), ("yi-9b", 12, {}),
            ("yi-9b", 12, {"attention_impl": "blocked"}), ("phi-3-vision-4.2b", 16, {}))
#: phases 34-37, whisper-tiny at full width and depth (4 encoder + 4
#: decoder layers): serving 8 prompts of 1500 tokens beside 1500 frames
#: (Whisper's 30 s encoder window; the launcher ties the two lengths) and 32
#: greedy steps; training 8 x 1500 (``TRAIN_CELLS``); card against CPU on
#: B 1, 300 frames and 256 tokens (35; T != S) and on 256 of each (37)
WHISPER = "whisper-tiny"
WHISPER_SERVE = (8, 1500, 32)
WHISPER_CUT = (300, 256)
#: phases 38-41, the MoE models at full width: arctic-480b (128 experts,
#: top-2, a dense residual) and kimi-k2-1t-a32b (384 experts, top-8, a
#: shared expert, a dense first layer), served at ``MOE_SERVE_LAYERS``
#: layers (38, 40: 55.4 / 39.2 GB of bf16 weights; at full depth neither
#: fits one card) on ``MOE_SERVE``, and card against CPU (39, 41) at
#: (n_layers, n_experts, prompt length) of ``MOE_CUT``, the experts cut so
#: the float32 host copy stays small (16 arctic experts: 6.7 GB)
ARCTIC, KIMI = "arctic-480b", "kimi-k2-1t-a32b"
MOE_SERVE_LAYERS = 2
MOE_SERVE = SERVE_SHAPE
MOE_CUT = {ARCTIC: (1, 16, 256), KIMI: (2, 32, 256)}
#: phase 39's full arctic MoE layer (128 experts) against ``moe_plain`` on
#: the card, B x S, in float32 (the CPU tests' bound: products summed in
#: other orders)
MOE_FULL = (1, 256)
MOE_PLAIN_TOL = 1e-5
#: the largest share of a prefill's rows the CPU may route to another set
#: of experts than the card on the card's MoE input (phases 39, 41)
FLIP_ROWS_MAX = 0.05
#: card vs CPU, one float32 training step at cut depth (phase 17): the loss,
#: relative; each gradient leaf, as a share of its max |g| (float32 products
#: and reductions summed in other orders on the two devices, through five
#: layers); one AdamW update on the same gradients, as a share of each
#: leaf's max |p| (a few float32 ulps: the two devices sum the global norm
#: in other orders)
TRAIN_LOSS_REL, TRAIN_GRAD_SHARE, OPT_CARD_CPU = 1e-5, 1e-4, 1e-6
ARCH = "recurrentgemma-2b"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def staircase(rng, n: int, k: int, np):
    """Seeded Monge instance with service-like widths: speedups in [1, ~3],
    capacities between n/4 and n devices per type."""
    a = 1.0 + 2.0 * np.cumsum(rng.uniform(0.05, 0.8, size=n)) / n
    c = np.cumsum(rng.uniform(0.2, 0.6, size=k))
    c = c - c[0]
    W = np.power(a[:, None], c[None, :])
    m = rng.integers(n // 4 + 1, n + 1, size=k).astype(np.float64)
    return W, m


def paper_instance(rng, n: int, np):
    """n tenants drawn from the paper's six job types (k = 3)."""
    from repro_torch.core.profiler import PAPER_WORKLOAD_SPEEDUPS as P

    names = sorted(P)
    return np.array([P[names[i]] for i in rng.integers(len(names), size=n)])


def graph_ms(torch, fn, reps: int = 50, rounds: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``rounds`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def once_ms(torch, fn) -> float:
    """Time of one ``fn()`` call as a caller sees it, between CUDA events
    (for a call too long to repeat; warm it first)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def call_ms(torch, fn, reps: int = 200) -> float:
    """Time of one ``fn()`` call as a caller sees it (host launch included):
    ``reps`` back-to-back calls between CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def service_trace(n_tenants: int, scale: int):
    """The cluster and trace of ``benchmarks/service_throughput.py``:
    ``n_tenants`` on 8 x ``scale`` devices of each of three types."""
    from repro_torch.core.types import ClusterSpec
    from repro_torch.service import synthetic_trace
    from repro_torch.service.traces import default_job_types

    cluster = ClusterSpec(types=("rtx3070", "rtx3080", "rtx3090"),
                          m=(8 * scale, 8 * scale, 8 * scale))
    events = synthetic_trace(
        n_tenants, job_types=default_job_types("paper"), cluster=cluster,
        duration_s=1800.0, mean_interarrival_s=1200.0, mean_work_s=1200.0,
        seed=0)
    return cluster, events


def service_replay(n_tenants: int, scale: int, backend: str, device: str,
                   until: float, record=None, tracer=None,
                   policy: str = "oef-noncoop"):
    """One replay as ``benchmarks/service_throughput.py`` builds it."""
    from repro_torch import obs
    from repro_torch.core import backends
    from repro_torch.service import OnlineScheduler

    cluster, events = service_trace(n_tenants, scale)
    sched = OnlineScheduler(cluster, policy, min_resolve_interval_s=30.0,
                            solver_backend=backend, device=device)

    def hook(program, backend_name, W, m):
        record.append((backend_name, W.copy(), m.copy()))

    if record is not None:
        backends.add_dispatch_hook(hook)
    if tracer is not None:
        obs.set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        report = sched.run(events, until=until)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if record is not None:
            backends.remove_dispatch_hook(hook)
    return sched, report, time.perf_counter() - t0


def decision_fields(report) -> dict:
    d = json.loads(report.to_json())
    return {k: v for k, v in d.items() if not k.startswith("resolve_latency")}


def agree(W, m, tau, X, np) -> float:
    """Hold a solve on the card against the CPU and the numpy greedy.

    The CPU solve runs the same multisection with the plain version, so tau
    and X must agree within 1e-9. The numpy greedy bisects to ~1e-13, while
    the multisection accepts a tau whose leftover mass is within
    1e-12*(1+n*tau), a few 1e-12 above the optimum; every user's share then
    carries that tau error and the boundary user absorbs the sum, up to
    n*|dtau|/min(W) devices (4e-9 at n = 1024 for the JAX tier as well). So
    against numpy tau must agree within 1e-9 and X within
    1e-9 + n*|dtau|/min(W). Returns the largest difference found.
    """
    from repro_torch.core import oef
    from repro_torch.core.torch_solve import solve_noncoop_fast_torch

    tau_c, X_c = solve_noncoop_fast_torch(W, m, device="cpu")
    d_cpu = max(abs(tau - tau_c), float(np.abs(X - X_c).max()))
    check(d_cpu <= PARITY, f"card vs CPU solve differ by {d_cpu:.3e}")
    ref = oef.solve_noncoop_waterfill(W, m)
    d_tau = abs(tau - ref.meta["tau"])
    d_x = float(np.abs(X - ref.X).max())
    allow = PARITY + W.shape[0] * d_tau / float(W.min())
    check(d_tau <= PARITY and d_x <= allow,
          f"vs numpy greedy: |dtau| {d_tau:.3e}, |dX| {d_x:.3e} > {allow:.3e}")
    return max(d_cpu, d_tau, d_x)


def instances_agree(record, np) -> float:
    """Re-solve every recorded instance on the card (cold) and hold it
    against the CPU and numpy (see ``agree``); returns the largest
    difference."""
    from repro_torch.core.torch_solve import solve_noncoop_fast_torch

    worst = 0.0
    for _backend, W, m in record:
        tau, X = solve_noncoop_fast_torch(W, m, device="cuda")
        worst = max(worst, agree(W, m, tau, X, np))
    return worst


def percentile(vals, q, np) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else 0.0


def bound(n_bytes: float, n_ops: float, flops: float = FP64_FLOPS,
          tc_ops: float = 0.0):
    """Least time on the card (ms) for the bytes and the operations: ``n_ops``
    at the ``flops`` rate (FP64 by default) and ``tc_ops`` float64 matrix
    product operations at the FP64 tensor-core rate; and which of the two
    bounds it."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n_ops / flops + tc_ops / FP64_TC_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def catalog_instance(rng, n: int, np, g: int = 5, k: int = 3):
    """n tenants drawn from a g-profile catalog (tests/test_jax_coop.py)."""
    cat = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(g, k)), axis=1)
    cat /= cat[:, :1]
    W = cat[rng.integers(0, g, size=n)]
    m = rng.uniform(1.0, 4.0, size=k) * n / 4
    return W, m


def distinct_instance(rng, n: int, np, k: int = 3):
    """n tenants with distinct rows (tests/test_jax_coop.py)."""
    W = np.cumprod(1.0 + rng.uniform(0.05, 1.0, size=(n, k)), axis=1)
    W /= W[:, :1]
    m = rng.uniform(1.0, 4.0, size=k) * n / 4
    return W, m


def envy_max(W, X, np) -> float:
    own = np.einsum("lk,lk->l", W, X)
    E = W @ X.T - own[:, None]
    np.fill_diagonal(E, 0.0)
    return float(E.max())


def host_ms(fn, reps: int = 50) -> float:
    """Median host time of one ``fn()`` call that ends in a copy to the host
    (so on the card's work), after three warm-up calls."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[len(ts) // 2]


def solve_operands(torch, np, rng, n_pad: int, k: int, B: int, dev):
    """B seeded staircase instances padded to ``n_pad``, as the padded
    ``(Wf, m, mask)`` of the solve on ``dev``."""
    from repro_torch.core import torch_solve

    insts = [torch_solve._prepare(*staircase(rng, n_pad - n_pad // 4, k, np))
             for _ in range(B)]
    check(all(i[1].shape[0] == n_pad for i in insts), f"bucket of n_pad {n_pad}")
    return [torch.as_tensor(np.stack([i[a] for i in insts]), dtype=torch.float64,
                            device=dev) for a in (1, 2, 3)]


def solve_phase(torch, np, wf, detail) -> dict:
    """Phase 3: the fused solve against the unfused path on the card and the
    plain solve on the CPU, its launches through the entry points, and its
    times at n = 1024, k = 3."""
    from repro_torch.core import oef, torch_solve

    lanes, iters = torch_solve.LANES, torch_solve.ITERS
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    cases, max_dx, max_cpu = 0, 0.0, 0.0
    for n_pad in (8, 128, 1024, 8192):
        for k in (3, 4, 40):  # 40: more types than the kernel's first version took
            for B in (1, 3):
                Wf, m, mask = solve_operands(torch, np, rng, n_pad, k, B, dev)
                cold, _ = wf.waterfill_solve_plain(
                    Wf, m, mask, torch.zeros(B, dtype=torch.float64, device=dev),
                    lanes=lanes, iters=iters, use_hint=False)
                for warm in (False, True):
                    hint = (cold * (1 - 1e-3) if warm
                            else torch.full((B,), -1.0, dtype=torch.float64, device=dev))
                    kw = {"lanes": lanes, "iters": iters, "use_hint": warm}
                    tau, X = wf.waterfill_solve(Wf, m, mask, hint, **kw)
                    tau2, X2 = wf.waterfill_solve(Wf, m, mask, hint, **kw)
                    ref_tau, ref_X = wf.waterfill_solve_plain(Wf, m, mask, hint, **kw)
                    cpu_tau, cpu_X = wf.waterfill_solve_plain(
                        *(t.cpu() for t in (Wf, m, mask, hint)), **kw)
                    torch.cuda.synchronize()
                    label = f"n_pad={n_pad} k={k} B={B} {'warm' if warm else 'cold'}"
                    check(torch.equal(tau, ref_tau),
                          f"{label}: fused tau differs from the unfused card path by "
                          f"{float((tau - ref_tau).abs().max()):.3e}")
                    check(torch.equal(tau, tau2) and torch.equal(X, X2),
                          f"{label}: a second launch differs")
                    d_x = float((X - ref_X).abs().max())
                    check(d_x <= TOL * float(m.max()),
                          f"{label}: |dX| vs the unfused card path {d_x:.3e}")
                    d_cpu = max(float((tau.cpu() - cpu_tau).abs().max()),
                                float((X.cpu() - cpu_X).abs().max()))
                    check(d_cpu <= PARITY, f"{label}: vs the CPU solve {d_cpu:.3e}")
                    max_dx, max_cpu = max(max_dx, d_x), max(max_cpu, d_cpu)
                    cases += 1
    log(f"[3] fused solve on {cases} cases (n_pad 8..8192, k 3/4/40, B 1/3, cold and "
        f"warm): tau bit-identical to the unfused card path, |dX| <= {max_dx:.3e} "
        f"(<= {TOL:g} max(m)); vs the CPU solve {max_cpu:.3e} (<= {PARITY:g}); a "
        f"second launch identical")

    # launches per solve through the entry points, against the CPU and numpy
    W = paper_instance(np.random.default_rng(2), 1024, np)
    m = np.full(3, 1024.0)
    tau_ref = oef.solve_noncoop_waterfill(W, m).meta["tau"]
    per_solve = {}
    masses_before = wf.waterfill_masses.launches
    for label, hint in (("cold", None), ("warm", tau_ref * (1 - 1e-3))):
        before = wf.waterfill_solve.launches
        got = oef.solve_noncoop_waterfill_torch(W, m, tau_hint=hint, device="cuda")
        per_solve[label] = wf.waterfill_solve.launches - before
        worst = agree(W, m, got.meta["tau"], got.X, np)
        check(got.meta["warm_started"] is (hint is not None), f"{label}: warm flag")
        log(f"    {label} solve n=1024 k=3: |dtau| "
            f"{abs(got.meta['tau'] - tau_ref):.3e}, largest difference vs CPU "
            f"and numpy {worst:.3e}, {per_solve[label]} launch")
    brng = np.random.default_rng(5)
    insts = [staircase(brng, 1000, 3, np) for _ in range(3)]
    Ws, ms = np.stack([i[0] for i in insts]), np.stack([i[1] for i in insts])
    before = wf.waterfill_solve.launches
    taus, Xs = torch_solve.solve_noncoop_fast_batch(Ws, ms, device="cuda")
    per_solve["batch3"] = wf.waterfill_solve.launches - before
    taus_c, Xs_c = torch_solve.solve_noncoop_fast_batch(Ws, ms, device="cpu")
    d_batch = max(float(np.abs(taus - taus_c).max()), float(np.abs(Xs - Xs_c).max()))
    check(d_batch <= PARITY, f"batch of 3: vs the CPU {d_batch:.3e}")
    check(per_solve == {"cold": 1, "warm": 1, "batch3": 1},
          f"launches per solve {per_solve}, want one each")
    check(wf.waterfill_masses.launches == masses_before,
          "a solve launched the standalone masses kernel")
    log(f"    batch of 3 x 1000 users: {per_solve['batch3']} launch, vs the CPU "
        f"{d_batch:.3e}; no launch of waterfill_masses")
    # more lanes than the fused kernel carries: the unfused route on the card,
    # one masses launch per probe and no fused launch
    before = (wf.waterfill_solve.launches, wf.waterfill_masses.launches)
    wide_tau, wide_X = torch_solve.solve_noncoop_fast_torch(W, m, lanes=2 * lanes,
                                                            device="cuda")
    per_route = (wf.waterfill_solve.launches - before[0],
                 wf.waterfill_masses.launches - before[1])
    check(per_route == (0, iters), f"a {2 * lanes}-lane solve: (fused, masses) "
          f"launches {per_route}, want (0, {iters})")
    d_wide = agree(W, m, wide_tau, wide_X, np)
    per_solve[f"lanes{2 * lanes}"] = {"fused": per_route[0], "masses": per_route[1]}
    log(f"    a {2 * lanes}-lane solve n=1024: the unfused route, {per_route[1]} masses "
        f"launches and no fused launch; vs CPU and numpy {d_wide:.3e}")

    # times at the service's shape: the fused kernel, one solve's execute
    # span, and the same solve the unfused way, as called and in a CUDA graph
    _, Wf_np, m_np, mask_np = torch_solve._prepare(W, m)
    hint_np = np.array([-1.0])
    Wf, m_d, mask, hint = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                           for a in (Wf_np[None], m_np[None], mask_np[None], hint_np))
    kw = {"lanes": lanes, "iters": iters, "use_hint": False}

    def execute(solve):
        def run():
            ops = torch_solve._to_device(dev, Wf_np[None], m_np[None], mask_np[None],
                                         hint_np)
            return torch_solve._to_host(*solve(*ops, **kw))
        return run

    n_pad, k = Wf_np.shape
    t = {"kernel_ms": graph_ms(torch, lambda: wf._launch_solve(Wf, m_d, mask, hint,
                                                               lanes, iters, False),
                               reps=20),
         "call_ms": call_ms(torch, lambda: wf.waterfill_solve(Wf, m_d, mask, hint, **kw),
                            reps=100),
         "execute_ms": host_ms(execute(torch_solve._solve_padded)),
         "unfused_execute_ms": host_ms(execute(wf.waterfill_solve_plain), reps=20),
         "plain_ms": call_ms(torch, lambda: wf.waterfill_solve_plain(
             Wf, m_d, mask, hint, **kw), reps=20),
         "library_ms": graph_ms(torch, lambda: wf.waterfill_solve_plain(
             Wf, m_d, mask, hint, **kw), reps=5)}
    n_bytes = 8 * (2 * n_pad * k + n_pad + k + 2)
    n_ops = 8 * n_pad * k * (lanes * iters + 1)
    t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops)
    log(f"    n=1024 (n_pad {n_pad}) k={k}: fused kernel {t['kernel_ms'] * 1e3:.2f} us "
        f"(graph replay; {t['call_ms'] * 1e3:.2f} us per wrapper call); one solve's "
        f"execute span {t['execute_ms']:.3f} ms; the unfused solve "
        f"{t['plain_ms'] * 1e3:.1f} us per call, {t['unfused_execute_ms']:.3f} ms "
        f"execute span, {t['library_ms'] * 1e3:.1f} us in a CUDA graph; bound "
        f"{t['bound_ms'] * 1e6:.1f} ns ({t['bound_by']})")
    detail["fused_solve"] = {"cases": cases, "max_dX_unfused": max_dx,
                             "max_diff_cpu": max_cpu, "launches_per_solve": per_solve,
                             "bytes": n_bytes, "fp64_ops": n_ops, **t}
    return {"max_abs_err": max_dx, **t}


def segment_operands(torch, np, rng, G: int, k: int, B: int, dev):
    """B seeded coop instances whose distinct rows pad to the group bucket
    G (a 5-profile catalog at G = 8, G - G/4 distinct rows above), as the
    padded PD operands and a zero state on ``dev``."""
    from repro_torch.core import torch_coop

    ops = []
    for _ in range(B):
        W, m = (catalog_instance(rng, 40, np, k=k) if G == 8
                else distinct_instance(rng, G - G // 4, np, k=k))
        Wd, _, cnt = torch_coop._reduce(W)
        Gi, Wp, cntp, _, pairm, tau, sig_env, sig_cap = torch_coop._padded_operands(
            Wd, cnt, k)
        check(Gi == G, f"bucket {Gi}, want {G}")
        ops.append((Wp, cntp, m, pairm, tau, sig_env, sig_cap))
    stacked = [np.stack([o[i] for o in ops]) for i in range(6)]
    return torch_coop._device_operands(
        dev, (*stacked, np.array([o[6] for o in ops])), np.zeros((B, G, k)),
        np.zeros((B, k)), np.zeros((B, G, G)))


def segment_phase(torch, np, ev, detail) -> dict:
    """Phase 6, second half: the fused PD segment against the stepwise
    segment on the card, and its times at G 8 and PD_FUSED_MAX_G."""
    from repro_torch.core.torch_coop import SEG_ITERS as seg

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    cases, max_err = 0, 0.0
    for G in (8, 32, ev.PD_FUSED_MAX_G):
        for k in (3, 4):
            for B in (1, 3):
                ops = segment_operands(torch, np, rng, G, k, B, dev)
                consts, state = ops[:7], ops[7:]
                for warm in (False, True):
                    if warm:  # the state after one stepwise segment
                        state = [a.contiguous() for a in
                                 ev.pd_segment_plain(*consts, *state, seg=seg)]
                    got = ev.pd_segment(*consts, *state, seg=seg)
                    again = ev.pd_segment(*consts, *state, seg=seg)
                    ref = ev.pd_segment_plain(*consts, *state, seg=seg)
                    torch.cuda.synchronize()
                    label = f"G={G} k={k} B={B} {'warm' if warm else 'cold'}"
                    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                    check(err <= TOL, f"{label}: fused vs stepwise segment {err:.3e}")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{label}: a second launch differs")
                    max_err = max(max_err, err)
                    cases += 1
    log(f"    fused PD segment == stepwise segment on {cases} cases (G 8/32/"
        f"{ev.PD_FUSED_MAX_G}, k 3/4, B 1/3, cold and warm; atol {TOL:g}), max "
        f"|diff| {max_err:.3e}; a second launch identical")
    times = {}
    for G in (8, ev.PD_FUSED_MAX_G):
        k = 3
        ops = segment_operands(torch, np, rng, G, k, 1, dev)
        t = {"kernel_ms": graph_ms(torch, lambda: ev._launch_segment(ops, seg), reps=10),
             "call_ms": call_ms(torch, lambda: ev.pd_segment(*ops, seg=seg), reps=20),
             "plain_ms": call_ms(torch, lambda: ev.pd_segment_plain(*ops, seg=seg),
                                 reps=3),
             "library_ms": graph_ms(torch, lambda: ev.pd_segment_plain(*ops, seg=seg),
                                    reps=1, rounds=3)}
        # per step: the products L^T Wp and Wp xb^T (4 G^2 k, tensor-core
        # rate); L's row sums, the gaps' subtraction and mask, L's update and
        # running sum (8 G^2); AtY's other terms, xn, xb, the own terms, p's
        # column sums, x's running sum (15 G k); p's update and sum (5 k).
        # Once: cvec, and the averages.
        t["bound_ms"], t["bound_by"] = bound(
            8 * (4 * G * k + 3 * G * G + 2 * G + 3 * k + 1),
            seg * (8 * G * G + 15 * G * k + 5 * k) + G * G + 2 * G * k + k,
            tc_ops=seg * 4 * G * G * k)
        times[G] = t
        log(f"    G={G} k={k}, {seg} steps: fused kernel {t['kernel_ms'] * 1e3:.1f} us "
            f"(graph replay; {t['call_ms'] * 1e3:.1f} us per wrapper call); the "
            f"stepwise segment {t['plain_ms']:.2f} ms per call, "
            f"{t['library_ms']:.3f} ms in a CUDA graph; bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    detail["pd_segment_kernel"] = {"cases": cases, "max_abs_err": max_err,
                                   "times": {str(G): t for G, t in times.items()}}
    return {"max_abs_err": max_err, **times[8]}


def envy_phase(torch, np, ev, detail) -> dict:
    """Phase 6: the envy-gap kernel against its plain version, and its times."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    max_err, cases = 0.0, 0
    for G in (8, 64, 512, 4096):
        for k in (3, 4):
            for B in (1, 3):
                W, X = (torch.as_tensor(rng.uniform(lo, hi, size=(B, G, k)),
                                        dtype=torch.float64, device=dev)
                        for lo, hi in ((0.5, 4.0), (0.0, 2.0)))
                got = ev.envy_gaps(W[0], X[0])[None] if B == 1 else ev.envy_gaps(W, X)
                ref = ev.envy_gaps_plain(W, X)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)
                max_err = max(max_err, float((got - ref).abs().max()))
                cases += 1
                del got, ref
    log(f"[6] envy kernel == plain on {cases} cases (atol=rtol={TOL:g}), "
        f"max |diff| {max_err:.3e}")
    times = {}
    for G in (8, 4096):
        k = 3
        W, X = (torch.as_tensor(rng.uniform(lo, hi, size=(G, k)),
                                dtype=torch.float64, device=dev)
                for lo, hi in ((0.5, 4.0), (0.0, 2.0)))
        W3, X3 = W[None], X[None]

        def library():
            return torch.addmm(-(W * X).sum(1, keepdim=True), W, X.T)

        torch.testing.assert_close(library(), ev.envy_gaps(W, X), atol=TOL, rtol=TOL)
        reps = 50 if G <= 512 else 10
        t = {"kernel_ms": graph_ms(torch, lambda: ev._launch(W3, X3), reps=reps),
             "call_ms": call_ms(torch, lambda: ev.envy_gaps(W, X),
                                reps=200 if G <= 512 else 20),
             "plain_ms": graph_ms(torch, lambda: ev.envy_gaps_plain(W3, X3),
                                  reps=reps),
             "library_ms": graph_ms(torch, library, reps=reps)}
        t["bound_ms"], t["bound_by"] = bound(8 * (2 * G * k + G * G), 2 * G * G * k)
        times[G] = t
        log(f"    G={G} k={k}: kernel {t['kernel_ms'] * 1e3:.2f} us (graph "
            f"replay; {t['call_ms'] * 1e3:.2f} us per wrapper call), plain "
            f"{t['plain_ms'] * 1e3:.2f} us, addmm {t['library_ms'] * 1e3:.2f} us, "
            f"bound {t['bound_ms'] * 1e6:.1f} ns ({t['bound_by']})")
    detail["envy_kernel"] = {"cases": cases, "max_abs_err": max_err,
                             "times": {str(G): t for G, t in times.items()}}
    return {"max_abs_err": max_err, **times[8]}


def route_launches(ev, G: int, pd_iters: int, seg: int):
    """The (fused, envy) launches ``pd_iters`` PD iterations at group
    bucket G make on the card: one fused launch per segment up to
    PD_FUSED_MAX_G, one envy launch per step above."""
    if ev.fused_segment("cuda", G):
        return pd_iters // seg, 0
    return 0, pd_iters


def coop_tier_phase(np, ev, detail) -> None:
    """Phase 7: the cooperative tier on the card against the CPU and the LP,
    on both routes of a PD segment."""
    from repro_torch.core import oef, torch_coop
    from repro_torch.core.backends import BackendError
    from repro_torch.core.torch_solve import bucket

    seg = torch_coop.SEG_ITERS

    def counts():
        return ev.pd_segment.launches, ev.envy_gaps.launches

    insts = [(f"catalog256/{s}", *catalog_instance(np.random.default_rng(10 + s),
                                                   256, np))
             for s in range(2)]
    insts.append(("distinct32", *distinct_instance(np.random.default_rng(1), 32, np)))
    out = {}
    for label, W, m in insts:
        before = counts()
        t0 = time.perf_counter()
        got = torch_coop.solve_coop_pd(W, m, device="cuda")
        card_s = time.perf_counter() - t0
        launches = tuple(a - b for a, b in zip(counts(), before))
        G = bucket(len(np.unique(W, axis=0)))
        want = route_launches(ev, G, got.meta["pd_iters"], seg)
        cpu = torch_coop.solve_coop_pd(W, m, device="cpu")
        lp = oef.solve_coop(W, m)
        o, o_cpu, o_lp = ((W * a.X).sum() for a in (got, cpu, lp))
        lb, ub = got.meta["objective_bounds"]
        d_x = float(np.abs(got.X - cpu.X).max())
        check((got.meta["pd_iters"], got.meta["crossover"])
              == (cpu.meta["pd_iters"], cpu.meta["crossover"]),
              f"{label}: card {got.meta['pd_iters']} {got.meta['crossover']} vs "
              f"CPU {cpu.meta['pd_iters']} {cpu.meta['crossover']}")
        check(abs(o - o_cpu) <= PARITY * max(abs(o_cpu), 1.0),
              f"{label}: objective {o} vs CPU {o_cpu}")
        check(d_x <= 1e-8 * float(m.max()), f"{label}: |dX| vs CPU {d_x:.3e}")
        check(ub - lb <= COOP_TOL * max(abs(lb), 1.0), f"{label}: gap {ub - lb:.3e}")
        check(abs(o - o_lp) <= COOP_TOL * max(abs(o_lp), 1.0),
              f"{label}: objective {o} vs LP {o_lp}")
        check(envy_max(W, got.X, np) <= COOP_TOL, f"{label}: envy")
        check(got.meta["pd_iters"] > 0 and launches == want,
              f"{label}: (fused, envy) launches {launches} for "
              f"{got.meta['pd_iters']} PD iterations at G {G}, want {want}")
        out[label] = {"pd_iters": got.meta["pd_iters"],
                      "crossover": got.meta["crossover"], "G": G,
                      "launches_fused": launches[0], "launches_envy": launches[1],
                      "card_s": card_s, "gap": ub - lb, "d_obj_lp": o - o_lp,
                      "dX_cpu": d_x}
        log(f"[7] {label}: {got.meta['pd_iters']} PD iterations "
            f"({got.meta['crossover']}) at G {G}, {launches[0]} fused launches and "
            f"{launches[1]} envy launches, {card_s * 1e3:.1f} ms on the card; |dX| vs "
            f"CPU {d_x:.3e}, gap {ub - lb:.3e}, objective - LP {o - o_lp:.3e}")
    # the batch API (tests/test_jax_coop.py's batch instance, three row
    # orders): one fused launch per segment for the whole batch
    W, m = catalog_instance(np.random.default_rng(5), 8, np)
    Ws = np.stack([W, W[::-1], W[np.random.default_rng(5).permutation(8)]])
    before = counts()
    Xs = torch_coop.solve_coop_batch(Ws, m, device="cuda")
    spent = tuple(a - b for a, b in zip(counts(), before))
    Xs_cpu = torch_coop.solve_coop_batch(Ws, m, device="cpu")
    d_batch = float(np.abs(Xs - Xs_cpu).max())
    check(d_batch <= 1e-8 * float(m.max()), f"batch: |dX| vs CPU {d_batch:.3e}")
    check(spent[0] > 0 and spent[1] == 0,
          f"batch: (fused, envy) launches {spent} for 3 instances")
    check(max(envy_max(Ws[b], Xs[b], np) for b in range(3)) <= COOP_TOL,
          "batch: envy")
    out["batch3x8"] = {"launches_fused": spent[0], "dX_cpu": d_batch}
    log(f"    batch of 3 x 8 tenants: {spent[0]} fused launches for the whole "
        f"batch, no envy launch, |dX| vs CPU {d_batch:.3e}")
    # distinct rows that the tier does not certify within a cut budget (nor
    # the JAX tier; the registry hands such instances to the LP): both
    # devices must spend exactly that budget and decline. 64 rows take the
    # fused route; 128 rows, above PD_FUSED_MAX_G, the stepwise one.
    for n, budget in ((64, 2 * seg), (128, seg)):
        W, m = distinct_instance(np.random.default_rng(0), n, np)
        for device in ("cuda", "cpu"):
            before = counts()
            try:
                torch_coop.solve_coop_pd(W, m, max_iters=budget, device=device)
            except BackendError:
                pass
            else:
                raise SmokeFailure(f"distinct{n} certified on {device} within {budget}")
            if device == "cuda":
                spent = tuple(a - b for a, b in zip(counts(), before))
                want = route_launches(ev, bucket(n), budget, seg)
                check(spent == want, f"distinct{n} on the card: (fused, envy) "
                      f"launches {spent}, want {want}")
        log(f"    distinct{n} (G {bucket(n)}): declined on the card after exactly "
            f"{budget} PD iterations, {spent[0]} fused and {spent[1]} envy launches, "
            f"as on the CPU")
        out[f"distinct{n}"] = {"budget": budget, "launches_fused": spent[0],
                               "launches_envy": spent[1]}
    detail["coop_tier"] = out


def coop_breakdown(tracer, wall: float) -> dict:
    """Where the traced coop replay's wall time went, by span."""
    stats = tracer.flame_stats()

    def total(pred):
        return sum(st["total_s"] for path, st in stats.items() if pred(path))

    return {
        "wall_s": wall,
        "events_s": total(lambda p: ";" not in p and p.startswith("event/")),
        "resolve_s": total(lambda p: p.endswith(";resolve")),
        "solve_s": total(lambda p: p.endswith(";resolve;solve")),
        "execute_s": total(lambda p: p.endswith(";execute")),
        "certify_s": total(lambda p: p.endswith(";certify")),
        "rescue_s": total(lambda p: p.endswith(";rescue")),
        "placement_s": total(lambda p: p.endswith(";resolve;placement")),
        "execute_n": sum(st["count"] for p, st in stats.items()
                         if p.endswith(";execute")),
    }


def coop_service_phase(torch, np, ev, wf, detail):
    """Phase 8: 256 tenants, oef-coop on the card; returns the launches of
    pd_segment and of envy_gaps (which must be 0)."""
    from repro_torch import obs
    from repro_torch.core import torch_coop
    from repro_torch.service.traces import default_job_types

    seg = torch_coop.SEG_ITERS
    torch_coop.prewarm(len(default_job_types("paper")), 3, device="cuda")
    others = (wf.waterfill_masses, wf.waterfill_solve, ev.envy_gaps)
    for w in (ev.pd_segment, *others):
        w.launches = 0
    sched, report, wall = service_replay(256, 32, "torch", "cuda", 7200.0,
                                         policy="oef-coop")
    launches = ev.pd_segment.launches
    other_launches = [w.launches for w in others]
    solved = [s for s in sched.metrics.solves if not s.reused]
    pd_iters = sum(s.pd_iters for s in solved)
    log(f"[8] 256 tenants / 768 devices, oef-coop, until 7200 s: "
        f"{report.n_solves} solves ({len(solved)} solved, "
        f"{sum(1 for s in solved if s.pd_iters == 0)} with no PD iteration), "
        f"{report.n_events} events, {report.jobs_finished} jobs finished, wall "
        f"{wall:.1f} s, {launches} fused PD-segment launches for {pd_iters} PD "
        f"iterations")
    check(set(report.solver_backends) == {"torch"},
          f"solver_backends {report.solver_backends}")
    check(report.fallback_count == 0, f"fallback_count {report.fallback_count}")
    check(report.degraded_solves == 0, f"degraded_solves {report.degraded_solves}")
    check("solver_floor" not in report.anomalies, f"anomalies {report.anomalies}")
    check(launches * seg == pd_iters >= seg,
          f"{launches} fused launches, {pd_iters} PD iterations")
    check(not any(other_launches), f"the coop replay launched waterfill_masses, "
          f"waterfill_solve, envy_gaps {other_launches} times")
    check(all(np.isfinite(list(report.steady_state_estimate.values()))),
          "non-finite throughput estimate")
    lat = [s.latency_s * 1e3 for s in solved]
    tracer = obs.Tracer()
    _, report2, wall2 = service_replay(256, 32, "torch", "cuda", 7200.0,
                                       tracer=tracer, policy="oef-coop")
    check(decision_fields(report) == decision_fields(report2),
          "second coop replay differs from the first")
    split = coop_breakdown(tracer, wall2)
    log(f"    resolve_latency_ms mean {report.resolve_latency_ms_mean:.3f} p95 "
        f"{report.resolve_latency_ms_p95:.3f} (all solves); solved mean "
        f"{float(np.mean(lat)):.3f} p95 {percentile(lat, 95, np):.3f}; second "
        f"replay identical (wall {wall2:.1f} s, traced): solve "
        f"{split['solve_s']:.2f} s (execute {split['execute_s']:.3f} s in "
        f"{split['execute_n']} segments, {split['execute_s'] / wall2:.2%} of wall, "
        f"certify {split['certify_s']:.2f} s, rescue {split['rescue_s']:.2f} s), "
        f"placement {split['placement_s']:.2f} s (stepwise segments, before the "
        f"fused kernel: wall 13.8 s, ~118 ms a segment, 10% of wall)")
    stats = tracer.flame_stats()
    top = sorted(stats.items(), key=lambda kv: -kv[1]["total_s"])[:14]
    detail["service_coop_256"] = {
        "n_solves": report.n_solves, "solved": len(solved),
        "no_pd_solves": sum(1 for s in solved if s.pd_iters == 0),
        "n_events": report.n_events, "jobs_finished": report.jobs_finished,
        "wall_s": wall, "launches": launches, "pd_iters": pd_iters,
        "resolve_latency_ms_mean": report.resolve_latency_ms_mean,
        "resolve_latency_ms_p95": report.resolve_latency_ms_p95,
        "solved_latency_ms_mean": float(np.mean(lat)),
        "solved_latency_ms_p95": percentile(lat, 95, np),
        "solver_share_of_wall": sum(s.latency_s for s in sched.metrics.solves) / wall,
        "traced": split, "flame_top": {p: st for p, st in top}}
    return launches, other_launches[2]


def coop_devices_phase(detail) -> None:
    """Phase 9: 64 tenants, oef-coop: card, CPU and the LP."""
    reports = {}
    for label, backend, device in (("cuda", "torch", "cuda"), ("cpu", "torch", "cpu"),
                                   ("numpy", "numpy", "cuda")):
        _, rep, w = service_replay(64, 8, backend, device, 7200.0, policy="oef-coop")
        reports[label] = rep
        log(f"[9] 64 tenants / 192 devices, oef-coop, {label:5s}: {rep.n_solves} "
            f"solves, {rep.jobs_finished} jobs, {rep.n_events} events, wall "
            f"{w:.1f} s, backends {rep.solver_backends}")
    a, b = reports["cpu"], reports["cuda"]
    check(set(b.solver_backends) == {"torch"} and b.fallback_count == 0,
          f"card replay backends {b.solver_backends}")
    d_tp = same_decisions(a, b, "card and CPU coop replays")
    c = reports["numpy"]
    for what, x, y in (("solves", c.n_solves, b.n_solves),
                       ("jobs finished", c.jobs_finished, b.jobs_finished),
                       ("events", c.n_events, b.n_events),
                       ("total throughput", sum(c.tenant_throughput.values()),
                        sum(b.tenant_throughput.values()))):
        check(abs(x - y) <= NUMPY_REL * max(abs(y), 1.0),
              f"LP coop replay's {what} {x} vs the card's {y}: more than "
              f"{NUMPY_REL:.0%} apart")
    log(f"    card == CPU coop replay (throughput diff {d_tp:.3e}), LP replay "
        f"within {NUMPY_REL:.0%}")
    detail["service_coop_64"] = {
        k: {"n_solves": r.n_solves, "jobs_finished": r.jobs_finished,
            "n_events": r.n_events} for k, r in reports.items()}


#: RG-LRU time steps per TMA tile (``kSteps`` in csrc/rglru_scan.cu):
#: phases 10 and 15 place S around it
RG_TILE = 32
#: the RG-LRU forward's timed shapes (phase 10): the training step's, and
#: the prefill's in float32 and in bf16
RG_FULL = (("train_fp32", TRAIN_SHAPE, "float32"),
           ("prefill_fp32", (8, 2048, 2560), "float32"),
           ("prefill_bf16", (8, 2048, 2560), "bfloat16"))


def rglru_operands(torch, g, dev, shape, dtype, h0_zero, misaligned=False, grad=False):
    """Seeded RG-LRU operands: a = sigmoid(N) and b = N in ``dtype``, h0 = N
    (or 0) in float32, and with ``grad`` an incoming dh = N. With
    ``misaligned``, a, b and dh are contiguous views one element into their
    buffers (4- or 2-byte aligned), which TMA cannot take."""
    B, S, D = shape

    def place(x):
        if not misaligned:
            return x
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:].copy_(x.reshape(-1))
        return buf[1:].view(x.shape)

    a = place(torch.sigmoid(torch.randn(shape, generator=g, device=dev)).to(dtype))
    b = place(torch.randn(shape, generator=g, device=dev).to(dtype))
    h0 = (torch.zeros((B, D), device=dev) if h0_zero
          else torch.randn((B, D), generator=g, device=dev))
    if not grad:
        return a, b, h0
    return a, b, h0, place(torch.randn(shape, generator=g, device=dev))


def rglru_route(torch, dtype, D: int, misaligned: bool) -> str:
    """The route the RG-LRU wrappers must take: ``"tma"`` for rows of D
    elements a multiple of 16 bytes (D % 4 == 0 in float32, D % 8 == 0 in
    bf16) at 16-byte aligned addresses, else ``"direct"``."""
    row_bytes = D * (4 if dtype == torch.float32 else 2)
    return "tma" if row_bytes % 16 == 0 and not misaligned else "direct"


def rglru_sass(detail) -> dict:
    """ptxas's registers and spills and the SASS TMA loads of the RG-LRU
    kernels: each TMA kernel must hold UTMALDG and none may spill."""
    report = {kernel_name(f): r for f, r in kernel_report("rglru_scan").items()
              if "rglru_scan" in f}
    tma = {f: r for f, r in report.items() if "_tma_kernel" in f}
    check(len(tma) >= 3, f"RG-LRU TMA kernels in the library: {sorted(report)}")
    for fn, rep in report.items():
        check(rep.get("UTMALDG", 0) > 0 or fn not in tma, f"{fn}: no UTMALDG in its SASS")
        check("spills" not in rep or "0 bytes spill stores, 0 bytes spill loads"
              in rep["spills"], f"{fn} spills: {rep}")
        log(f"    {fn}: {rep.get('registers', 'registers not reported')}; "
            f"{rep.get('spills', 'spills not reported')}; UTMALDG {rep.get('UTMALDG', 0)}")
    detail["rglru_sass"] = report
    return report


def rglru_phase(torch, rg, detail, dev="cuda") -> dict:
    """Phase 10: the RG-LRU forward kernels against their plain version, bit
    for bit, on the route ``_route`` names and, where that is the TMA
    kernel, on the direct one too; the kernels' ptxas report and SASS; and
    both kernels' times at the training and prefill shapes."""
    g = torch.Generator(device=dev).manual_seed(10)
    f32, bf16 = torch.float32, torch.bfloat16
    T = RG_TILE
    # (shape, dtype, h0 = 0, misaligned views): the timed full-width shapes,
    # then the JAX kernel test's range and the TMA kernel's edges
    cases = [(shape, getattr(torch, dt), True, False) for _, shape, dt in RG_FULL]
    cases.append((sched_rglru_shape(), f32, True, False))  # phase 26's tenant
    cases += [((1, 64, 32), f32, False, False), ((2, 128, 64), f32, False, False),
              ((3, 192, 128), f32, False, False), ((3, 256, 256), f32, False, False),
              ((2, 64, 96), f32, False, False), ((2, 1, 2560), f32, False, False),
              ((2, 17, 256), f32, False, False),  # S below one tile
              ((2, T - 1, 256), f32, False, False), ((2, T + 1, 256), f32, False, False),
              ((1, 4097, 256), f32, False, False), ((3, 200, 32), f32, False, False),
              ((1, 128, 2568), f32, False, False),  # a ragged 32-feature column
              ((1, 130, 2564), f32, False, False), ((2, 64, 96), bf16, False, False),
              ((1, 4097, 256), bf16, False, False),
              ((1, 130, 2564), bf16, False, False),  # bf16 with D % 8 != 0
              ((2, 65, 100), bf16, False, False),
              ((2, 70, 97), f32, False, False),  # float32 with D % 4 != 0
              ((2, 129, 256), f32, False, True), ((1, 64, 256), bf16, False, True)]
    runs = {"tma": 0, "direct": 0}
    max_err = 0.0
    for shape, dtype, h0_zero, misaligned in cases:
        a, b, h0 = rglru_operands(torch, g, dev, shape, dtype, h0_zero, misaligned)
        route = rglru_route(torch, dtype, shape[2], misaligned)
        what = f"rglru_scan {shape} {dtype}{' misaligned' if misaligned else ''}"
        ref = rg.rglru_scan_plain(a, b, h0)
        before = (rg.rglru_scan.launches, rg.rglru_scan.launches_tma)
        outs = {route: rg.rglru_scan(a, b, h0)}
        took = (rg.rglru_scan.launches - before[0], rg.rglru_scan.launches_tma - before[1])
        check(took == (1, int(route == "tma")),
              f"{what}: {took[0]} launches, {took[1]} on the TMA kernel; want the {route} route")
        if route == "tma":
            outs["direct"] = rg._launch(a, b, h0, route="direct")
            check(rg.rglru_scan.launches_tma == before[1] + 1,
                  f"{what}: the direct route counted a TMA launch")
        torch.cuda.synchronize()
        for r, got in outs.items():
            check(got.dtype == dtype and tuple(got.shape) == shape,
                  f"{what}: got {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - ref.float()).abs().max())
            check(torch.equal(got, ref), f"{what}: the {r} kernel differs from the "
                  f"plain version (max |diff| {err:.3e})")
            max_err = max(max_err, err)
            runs[r] += 1
        del a, b, h0, ref, outs
    log(f"[10] rglru_scan kernels == plain bit for bit on {len(cases)} cases ({runs['tma']} "
        f"runs on the TMA kernel, {runs['direct']} on the direct one), one launch per call "
        f"on the expected route")
    rglru_sass(detail)

    full = {}
    for label, shape, dt in RG_FULL:
        B, S, D = shape
        dtype = getattr(torch, dt)
        a, b, h0 = rglru_operands(torch, g, dev, shape, dtype, True)
        row = dict(zip(("bound_ms", "bound_by"), bound(3 * B * S * D * a.element_size(),
                                                       2 * B * S * D, FP32_FLOPS)))
        for r, call in (("tma", lambda: rg.rglru_scan(a, b, h0)),
                        ("direct", lambda: rg._launch(a, b, h0, route="direct"))):
            ms = graph_ms(torch, lambda: rg._launch(a, b, h0, route=r), reps=20)
            row[r] = {"kernel_ms": ms, "call_ms": call_ms(torch, call, reps=50),
                      "share_of_bound": row["bound_ms"] / ms}
        full[label] = row
        log(f"    {shape} {dt}: TMA kernel {row['tma']['kernel_ms'] * 1e3:.2f} us "
            f"({row['tma']['share_of_bound']:.1%} of the bound; wrapper call "
            f"{row['tma']['call_ms'] * 1e3:.2f} us), direct kernel "
            f"{row['direct']['kernel_ms'] * 1e3:.2f} us ({row['direct']['share_of_bound']:.1%};"
            f" call {row['direct']['call_ms'] * 1e3:.2f} us), bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
        if label != "prefill_fp32":
            del a, b, h0
            continue
        t = {"plain_ms": graph_ms(torch, lambda: rg.rglru_scan_plain(a, b, h0),
                                  reps=1, rounds=2),
             "library_ms": None}
        # the nearest library form: a private API, timed only as a yardstick
        import importlib.util
        if importlib.util.find_spec("torch._higher_order_ops.associative_scan"):
            from torch._higher_order_ops.associative_scan import associative_scan

            def combine(x, y):
                return x[0] * y[0], y[0] * x[1] + y[1]

            def library():
                return associative_scan(combine, (a, b), dim=1, combine_mode="generic")[1]

            torch.testing.assert_close(library(), rg._launch(a, b, h0), atol=1e-5, rtol=1e-4)
            t["library_ms"] = call_ms(torch, library, reps=3)
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
        log(f"    {shape} {dt}: plain {t['plain_ms'] * 1e3:.2f} us, associative_scan {lib}")
        del a, b, h0
    pre = full["prefill_fp32"]
    out = {"cases": len(cases), "runs": runs, "max_abs_err": max_err, "shapes": full,
           "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"], **t,
           "kernel_ms": pre["tma"]["kernel_ms"], "call_ms": pre["tma"]["call_ms"],
           "direct_ms": pre["direct"]["kernel_ms"]}
    detail["rglru_kernel"] = out
    return out


def device_kernels(torch, fn) -> list:
    """The device kernels of one ``fn()`` call, from ``torch.profiler``:
    ``{"op", "device_ms", "count"}`` per kernel name (as ``key_averages``
    names them), most device time first. The trace's device events are
    summed from its raw events: ``key_averages`` builds a Python object for
    every event of the trace, host and device, ~100 us each, which took
    minutes for the xLSTM's traced step (its sLSTM loop launches ~10^5
    small ops)."""
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = sums.setdefault(_rewrite_name(e.name(), with_wildcard=True), [0, 0])
            row[0] += e.end_ns() - e.start_ns()
            row[1] += 1
    rows = [{"op": k, "device_ms": ns / 1e6, "count": n} for k, (ns, n) in sums.items()]
    return sorted(rows, key=lambda r: -r["device_ms"])


def mixer_layers(cfg, kind: str) -> tuple:
    """The layers of ``cfg`` whose mixer is ``kind``: in the pattern units
    (which ``remat="full"`` recomputes in the backward), and in all."""
    n_unit = cfg.n_units * cfg.pattern.count(kind)
    return n_unit, n_unit + cfg.tail_kinds.count(kind)


def rglru_layers(cfg) -> tuple:
    """The RG-LRU layers of ``cfg``, in the units and in all."""
    return mixer_layers(cfg, "rglru")


def slstm_layers(cfg) -> tuple:
    """The sLSTM layers of ``cfg``, in the units and in all (one scan
    launch each a prefill and a decode step)."""
    return mixer_layers(cfg, "slstm")


def step_launches(cfg) -> dict:
    """Every kernel launch of one train step of ``cfg`` by wrapper (the
    nonzero ones): the RG-LRU and sLSTM forwards once a layer and again a
    layer of each unit that ``remat="full"`` recomputes, their backwards
    once a layer."""
    full = cfg.remat == "full"
    counts = {}
    for kind, fwd, bwd in (("rglru", "rglru_scan", "rglru_scan_backward"),
                           ("slstm", "slstm_scan", "slstm_scan_backward")):
        n_unit, n_all = mixer_layers(cfg, kind)
        counts.update({fwd: n_all + (n_unit if full else 0), bwd: n_all})
    return {k: n for k, n in counts.items() if n}


def layer_kinds_of(cfg) -> list:
    """Each layer's kind, in order: ``Model.kinds`` of ``cfg`` built on the
    meta device."""
    from repro_torch.models import Model

    return Model(cfg, device="meta").kinds


def blocked_layers(cfg) -> int:
    """The flash launches of one prefill of ``cfg``: one per attention layer
    on the blocked path, none on the xla path."""
    if cfg.attention_impl != "blocked":
        return 0
    return sum(kind in ("full", "sliding") for kind in layer_kinds_of(cfg))


def run_key(arch: str, cfg) -> str:
    """A run's name in ``detail``: ``arch``, with ``_blocked`` on the
    blocked attention path."""
    return f"{arch}_blocked" if cfg.attention_impl == "blocked" else arch


def _zero_launches(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def _launches(wrappers) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def _want(wrappers, **counts) -> dict:
    """Launches a path must make: ``counts`` for the named wrappers, 0 for
    every other."""
    return dict(dict.fromkeys(wrappers, 0), **counts)


def _tf32_off(torch) -> None:
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matrix products must run in full float32 (TF32 is on)")


def serve_phase(torch, rg, detail, rg_t, phase=11, arch=ARCH, dev="cuda", cfg=None,
                logits_out=None, shape=None, after=None) -> int:
    """Phases 11, 18, 22, 30, 34, 38 and 40: serve ``arch`` at full width through
    ``launch.serve.generate``, ``shape`` (default ``SERVE_SHAPE``) prompts
    and greedy steps (an ``embeddings`` model's prompts, and an encoder
    model's frames of the prompts' length, as ``prompt_batch`` builds them);
    returns the RG-LRU launches of the main run. Each RG-LRU layer launches
    the TMA kernel once a prefill, the blocked path one flash launch per
    attention layer a prefill, all on the tensor-core kernel, each sLSTM
    layer the scan kernel once a prefill and once a decode step, and no
    other kernel wrapper may launch (the grouped-einsum attention and the
    mLSTM are plain torch, as the JAX model's). ``logits_out`` receives the
    main run's prefill logits on the host and its final-normed hidden state
    at every position on the card. ``after``
    (model, prompts, cache_len) runs last on the served model before it is
    freed; what it returns is the record's ``after``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wrappers
    from repro_torch.launch.serve import generate, prompt_batch
    from repro_torch.models import decode_step, init_params, prefill

    _tf32_off(torch)
    full = cfg is None
    cfg = get_config(arch) if full else cfg
    flash = blocked_layers(cfg)
    B, S, steps = shape or SERVE_SHAPE
    ws = wrappers()
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(0)
        model = init_params(cfg, g)
        n_rglru, n_slstm = rglru_layers(cfg)[1], slstm_layers(cfg)[1]
        prompts = torch.randint(2, cfg.vocab, (B, S), generator=g, device=dev)
        generate(model, prompts, steps)  # warm-up
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(ws)
        rg.rglru_scan.launches_tma = fa.flash_attention.launches_tc = 0
        hidden = {}
        with (prefill_hidden(model, hidden, "hidden") if logits_out is not None
              else contextlib.nullcontext()):
            toks, rec = generate(model, prompts, steps)
        launches, launches_tma = rg.rglru_scan.launches, rg.rglru_scan.launches_tma
        flash_tc = fa.flash_attention.launches_tc
        want = _want(ws, rglru_scan=n_rglru, flash_attention=flash, slstm_scan=n_slstm)
        want_dec = _want(ws, slstm_scan=n_slstm * steps)
        check(not full or arch != ARCH or n_rglru == 18,
              f"{n_rglru} RG-LRU layers at full width")
        check(_launches(ws) == {k: want[k] + want_dec[k] for k in ws}
              and rec["prefill_kernel_launches"] == want
              and rec["decode_kernel_launches"] == want_dec,
              f"{arch}: kernel launches in prefill {rec['prefill_kernel_launches']}, "
              f"in decode {rec['decode_kernel_launches']}; want {n_rglru} RG-LRU, "
              f"{flash} flash and {n_slstm} sLSTM launches a prefill, {n_slstm} sLSTM "
              f"launches a decode step and no other launch")
        check(launches_tma == launches,
              f"{launches - launches_tma} of {launches} RG-LRU launches "
              f"took the direct route, not the TMA one")
        check(flash_tc == flash, f"{flash_tc} of {flash} flash launches took the "
              f"tensor-core kernel")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        logits = rec["logits"]
        if logits_out is not None:
            logits_out["prefill"] = logits.float().cpu()
            logits_out["hidden"] = hidden["hidden"]
        for key in ("logits", "last_logits"):
            check(tuple(rec[key].shape) == (B, 1, cfg.padded_vocab)
                  and bool(torch.isfinite(rec[key]).all()),
                  f"{arch}: {key} of shape {tuple(rec[key].shape)} or not finite")
        check(tuple(toks.shape) == (B, steps + 1)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch}: tokens out of [0, {cfg.vocab})")
        toks2, rec2 = generate(model, prompts, steps)
        check(torch.equal(toks, toks2) and torch.equal(logits, rec2["logits"])
              and torch.equal(rec["last_logits"], rec2["last_logits"]),
              f"{arch}: a second run with the same weights and prompts differs")
        batch = prompt_batch(model, prompts)
        t_prof = time.perf_counter()
        kernels = device_kernels(torch, lambda: prefill(model, batch, S + steps + 8))
        t_prof = time.perf_counter() - t_prof
        cache, _ = prefill(model, batch, S + steps + 8)

        def decode_steps():  # greedy steps from the prompts' cache
            c, tok = cache, toks[:, :1]
            for _ in range(DECODE_PROFILE_STEPS):
                c, lg = decode_step(model, c, tok)
                tok = torch.argmax(lg[:, -1, :cfg.vocab], dim=-1)[:, None]

        t_dec = time.perf_counter()
        decode_kernels = device_kernels(torch, decode_steps)
        t_dec = time.perf_counter() - t_dec
        del cache, batch
        extra = after(model, prompts, S + steps + 8) if after is not None else None
    del model
    prefill_s = min(rec["prefill_s"], rec2["prefill_s"])
    decode_s = min(rec["decode_s"], rec2["decode_s"])
    busy_ms = sum(k["device_ms"] for k in kernels)
    rglru_ms = sum(k["device_ms"] for k in kernels if "rglru_scan_tma_kernel" in k["op"])
    flash_ms = sum(k["device_ms"] for k in kernels if "flash" in k["op"])
    slstm_ms = sum(k["device_ms"] for k in kernels if "slstm_forward_kernel" in k["op"])
    decode_busy_ms = sum(k["device_ms"] for k in decode_kernels) / DECODE_PROFILE_STEPS
    out = {"batch": B, "prompt_len": S, "decode_steps": steps, "warmup_s": warm_s,
           "prefill_s": [rec["prefill_s"], rec2["prefill_s"]],
           "decode_s": [rec["decode_s"], rec2["decode_s"]],
           "prefill_tok_s": B * S / prefill_s, "decode_tok_s": B * steps / decode_s,
           "prefill_launches": rec["prefill_launches"], "launches_tma": launches_tma,
           "flash_launches_tc": flash_tc,
           "decode_launches": rec["decode_launches"],
           "kernel_launches": rec["prefill_kernel_launches"],
           "decode_kernel_launches": rec["decode_kernel_launches"],
           "kernel_share_of_prefill": n_rglru * rg_t["kernel_ms"] / 1e3 / prefill_s,
           "profiled_prefill": {"layers": cfg.n_layers, "untraced_s": prefill_s,
                                "device_busy_ms": busy_ms, "rglru_scan_ms": rglru_ms,
                                "flash_ms": flash_ms, "slstm_scan_ms": slstm_ms,
                                "idle_share": 1.0 - busy_ms / 1e3 / prefill_s,
                                "top_kernels": kernels[:15]},
           "profiled_decode_step": {
               "device_busy_ms": decode_busy_ms,
               "idle_share": 1.0 - decode_busy_ms / 1e3 / (decode_s / steps),
               "top_kernels": [dict(k, device_ms=k["device_ms"] / DECODE_PROFILE_STEPS,
                                    count=k["count"] / DECODE_PROFILE_STEPS)
                               for k in decode_kernels[:10]]},
           "peak_memory_gb": peak_gb, "first_tokens": toks[:, :8].tolist(),
           "profile_s": {"prefill": t_prof, "decode": t_dec}, "after": extra,
           "seconds": time.perf_counter() - t_start}
    detail[f"serve_{run_key(arch, cfg)}"] = out
    launched = {k: n for k, n in want.items() if n} or "none"
    launched_dec = {k: n for k, n in want_dec.items() if n} or "none"
    log(f"[{phase}] {cfg.name} ({cfg.n_layers} layers, {cfg.attention_impl} attention) at "
        f"full width, {B} x {S} prompt + {steps} greedy steps "
        f"(warm-up {warm_s:.2f} s): prefill {prefill_s:.3f} s "
        f"({out['prefill_tok_s']:.0f} tok/s), decode {decode_s:.3f} s "
        f"({out['decode_tok_s']:.1f} tok/s); kernel launches a prefill {launched} "
        f"(RG-LRU all on the TMA kernel, {out['kernel_share_of_prefill']:.2%} of "
        f"prefill; flash {flash_tc} on the tensor-core kernel), in decode "
        f"{launched_dec}, none of "
        f"{', '.join(k for k in ws if not want[k] and not want_dec[k])}; "
        f"logits {tuple(logits.shape)} finite; peak {peak_gb:.2f} GB; second run "
        f"identical")
    pp = out["profiled_prefill"]
    log(f"    one profiled prefill: kernels busy {busy_ms:.1f} ms (device idle "
        f"{pp['idle_share']:.1%} of the untraced prefill, {pp['untraced_s']:.3f} s), "
        f"rglru_scan {rglru_ms:.2f} ms, flash {flash_ms:.2f} ms, slstm_scan {slstm_ms:.2f} "
        f"ms; top: " + "; ".join(
            f"{k['op'][:48]} {k['device_ms']:.1f} ms x{k['count']}" for k in kernels[:4]))
    dec = out["profiled_decode_step"]
    log(f"    {DECODE_PROFILE_STEPS} profiled decode steps: kernels busy {decode_busy_ms:.2f} ms a step (device "
        f"idle {dec['idle_share']:.1%} of an untraced step, {decode_s / steps * 1e3:.2f} "
        f"ms); top: " + "; ".join(f"{k['op'][:48]} {k['device_ms']:.2f} ms x{k['count']:g}"
                                   for k in dec["top_kernels"][:4]))
    return launches


@contextlib.contextmanager
def prefill_hidden(model, out: dict, key: str):
    """While open, ``out[key]`` receives the final-normed output of
    ``model``'s last layer at every position (the input of the logits) from
    the first full-sequence call, a prefill; decode steps do not call the
    layer's forward."""
    def hook(_layer, _args, output):
        if key not in out:
            x = output[0] if isinstance(output, tuple) else output
            out[key] = model.final_norm(x)

    handle = model.layers[-1].register_forward_hook(hook)
    try:
        yield out
    finally:
        handle.remove()


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float32; 0 for equal all-zero tensors (an
    initial state's gradient that no step reaches)."""
    a, b = a.float(), b.float()
    diff, scale = float((a - b).abs().max()), float(b.abs().max())
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


@contextlib.contextmanager
def planted_noncausal(model):
    """A planted fault for phase 31's control: every flash call of the
    blocked path made non-causal (rows see later keys; the last row sees
    the same keys as before)."""
    from repro_torch.kernels import ops

    real = ops.flash_attention_gqa
    ops.flash_attention_gqa = lambda q, k, v, **kw: real(q, k, v, **dict(kw, causal=False))
    try:
        yield
    finally:
        ops.flash_attention_gqa = real


@contextlib.contextmanager
def planted_no_window(model):
    """A planted fault for phase 31's control: the sliding layers attend
    to every earlier position (their window dropped)."""
    sliding = [layer.mixer for layer in model.layers if layer.kind == "sliding"]
    windows = [m.window for m in sliding]
    for m in sliding:
        m.window = None
    try:
        yield
    finally:
        for m, w in zip(sliding, windows):
            m.window = w


def decode_on(model, prompts, toks, cache_len: int, frames=None):
    """The logits of the last of ``generate``'s decode steps when ``model``
    is fed the tokens ``toks`` (B, steps + 1) after prefilling ``prompts``
    (and an encoder model's ``frames``; the last token of ``toks`` is an
    output and is not fed)."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import decode_step, prefill

    cache, logits = prefill(model, prompt_batch(model, prompts, frames), cache_len)
    for i in range(toks.shape[1] - 1):
        cache, logits = decode_step(model, cache, toks[:, i:i + 1])
    return logits


def moe_layers(model) -> list:
    """The MoE FFNs of ``model`` (a model, a block or a MoE layer), in order."""
    from repro_torch.models.layers import MoE

    return [m for m in model.modules() if isinstance(m, MoE)]


def routing_of(moe, x, keep_x: bool = False) -> dict:
    """MoE layer ``moe``'s own routing of its input ``x`` (B, S, d), on the
    host: the router logits (B, S, E) float32, the expert ids ``idx``
    (B, S, k), ``kept`` (B, S, k) (in token order: within its expert's
    capacity), ``cap``, ``ties``, the tokens whose k-th and (k+1)-th
    probabilities are equal (where the tie order decides the expert), and
    with ``keep_x`` the input ``x``. The layer's class methods, so under
    ``forced_routes`` too."""
    import torch

    from repro_torch.models.layers import MoE

    logits, probs, _, idx = MoE.route(moe, x)
    order, keep, _, cap = MoE.dispatch(moe, idx, x.shape[1])
    kept = torch.empty_like(keep).scatter_(1, order, keep).view(idx.shape)
    k = idx.shape[-1]
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[0]
    return {"logits": logits.cpu(), "idx": idx.cpu(), "kept": kept.cpu(), "cap": cap,
            "ties": int((top[..., k - 1] == top[..., k]).sum()),
            "x": x.cpu() if keep_x else None}


@contextlib.contextmanager
def tapped_routes(model, keep_x: bool = False):
    """While open, every forward of a MoE layer of ``model`` appends
    ``routing_of`` its input to the yielded list."""
    calls = []

    def hook(moe, args):
        calls.append(routing_of(moe, args[0], keep_x))

    handles = [m.register_forward_pre_hook(hook) for m in moe_layers(model)]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def flip_margin(mag, dtype: str):
    """The router-logit gap under which rounding may order two experts of
    larger logit magnitude ``mag`` either way: 2 bf16 ulps in bf16 (the
    router product is rounded to bf16 on each device), 1e-5 relative in
    float32."""
    import torch

    if dtype == "bfloat16":
        return 2.0 * torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return 1e-5 * mag


def route_check(ref_calls, got_calls, dtype: str) -> dict:
    """One forward's routing on two sides, MoE layer by layer
    (``tapped_routes`` calls in order; ``ref`` is the side whose logits
    judge), token by token as sets of experts: the order of a token's k
    experts changes neither its output nor any expert's queue, so only a
    token whose set differs flipped. ``tokens`` flipped, ``pairs`` the
    experts swapped in (counted on one side), of those tokens
    ``unjustified`` the ones whose swapped experts (in on either side)
    span more than ``flip_margin`` of the reference logits (a near-tie
    broken the other way spans less); ``kept_diff``, the (token, expert)
    assignments on both sides whose kept flag differs, of which
    ``kept_unexplained`` have no flip into or out of that expert at an
    earlier token of their batch row (a flip moves the rest of its
    expert's queue by one); ``reordered``, tokens with the same set in
    another order; ``rows`` (B, S) bool, the rows whose routing differs at
    some layer. Every row is judged at every layer, so a later layer's
    inputs must not follow from an earlier layer's flips: the two sides
    route the same input, or the same routes (``forced_routes``)."""
    import torch

    rows, out = None, dict.fromkeys(("tokens", "pairs", "unjustified", "kept_diff",
                                     "kept_unexplained", "reordered"), 0)
    for ref, got in zip(ref_calls, got_calls):
        sa, oa = torch.sort(ref["idx"], dim=-1)
        sb, ob = torch.sort(got["idx"], dim=-1)
        ka, kb = torch.gather(ref["kept"], -1, oa), torch.gather(got["kept"], -1, ob)
        B, S, k = sa.shape
        rows = torch.zeros((B, S), dtype=torch.bool) if rows is None else rows
        match = sa[..., :, None] == sb[..., None, :]  # (B, S, k, k)
        in_a, in_b = match.any(-1), match.any(-2)
        flipped = ~in_a.all(-1)
        la, lb = (torch.gather(ref["logits"], -1, i) for i in (sa, sb))
        inf = torch.tensor(float("inf"))
        hi = torch.maximum(torch.where(in_a, -inf, la).amax(-1),
                           torch.where(in_b, -inf, lb).amax(-1))
        lo = torch.minimum(torch.where(in_a, inf, la).amin(-1),
                           torch.where(in_b, inf, lb).amin(-1))
        wide = flipped & ((hi - lo) > flip_margin(torch.maximum(hi.abs(), lo.abs()), dtype))
        kb_at_a = (match & kb[..., None, :]).any(-1)
        kd = in_a & (ka != kb_at_a)
        out["tokens"] += int(flipped.sum())
        out["pairs"] += int((~in_a).sum())
        out["unjustified"] += int(wide.sum())
        out["reordered"] += int((~flipped & (ref["idx"] != got["idx"]).any(-1)).sum())
        out["kept_diff"] += int(kd.sum())
        for b, t, j in kd.nonzero().tolist():
            e = sa[b, t, j]
            swapped = ((sa[b, :t] == e) & ~in_a[b, :t]) | ((sb[b, :t] == e) & ~in_b[b, :t])
            out["kept_unexplained"] += not bool(swapped.any())
        rows = rows | flipped | kd.any(-1)
    out["n_rows"] = int(rows.sum())
    out["rows"] = rows
    return out


def card_cpu_routes(cpu_model, cpu_calls, card_calls, dtype: str) -> dict:
    """The routing-flip rule of phases 39 and 41 for one forward's MoE
    layers, tapped with their inputs. The router's product is rounded to
    the compute dtype on each device, so on one input the two devices may
    order near-tied experts differently: the CPU routes the card's input
    itself, and every token it sends to another set of experts than the
    card did must be a near-tie on the CPU's logits (``route_check``:
    ``unjustified``, ``kept_unexplained``), on at most ``FLIP_ROWS_MAX`` of
    the rows (``device_rows`` of ``rows_of``). The CPU's routing of its own
    input, which differs from the card's by the rounding upstream, is
    recorded (``tokens``, ``pairs``, ``reordered``, ``n_rows``)."""
    same = [routing_of(m, c["x"]) for m, c in zip(moe_layers(cpu_model), card_calls)]
    device = route_check(same, card_calls, dtype)
    own = route_check(cpu_calls, card_calls, dtype)
    return {"tokens": own["tokens"], "pairs": own["pairs"], "reordered": own["reordered"],
            "n_rows": own["n_rows"], "device_tokens": device["tokens"],
            "device_reordered": device["reordered"], "device_rows": device["n_rows"],
            "rows_of": device["rows"].numel(), "unjustified": device["unjustified"],
            "kept_diff": device["kept_diff"], "kept_unexplained": device["kept_unexplained"]}


@contextlib.contextmanager
def attention_impl(model, impl: str):
    """While open, every attention layer of ``model`` runs
    ``attention_impl=impl`` on the same weights (each reads its config
    when called)."""
    import dataclasses

    from repro_torch.models.layers import Attention

    mods = [m for m in model.modules() if isinstance(m, Attention)]
    saved = [m.cfg for m in mods]
    for m in mods:
        m.cfg = dataclasses.replace(m.cfg, attention_impl=impl)
    try:
        yield
    finally:
        for m, c in zip(mods, saved):
            m.cfg = c


@contextlib.contextmanager
def twin_attention():
    """While open, the blocked path runs its twin
    ``layers.blocked_attention_plain`` on the card too (``_on_kernel``
    answers no)."""
    from repro_torch.models import layers

    real = layers._on_kernel
    layers._on_kernel = lambda q, k, v: False
    try:
        yield
    finally:
        layers._on_kernel = real


@contextlib.contextmanager
def forced_routes(model, calls):
    """While open, the MoE layers of ``model`` route each token to the
    experts of the ``tapped_routes`` ``calls`` (of one or more forwards,
    each its MoE layers in order; a layer takes its calls in turn), gated
    by their own probabilities at those experts, renormalised: the output
    is then continuous in the input, so two runs that differ by rounding
    compare at every position."""
    import torch

    mods = moe_layers(model)
    for i, m in enumerate(mods):
        def route(x, real=m.route, todo=iter(calls[i::len(mods)])):
            logits, probs, _, _ = real(x)
            idx = next(todo)["idx"].to(x.device)
            gates = torch.gather(probs, -1, idx)
            return logits, probs, gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx
        m.route = route
    try:
        yield
    finally:
        for m in mods:
            del m.route


@contextlib.contextmanager
def planted_no_renorm(model):
    """A planted fault for phases 39 and 41: every MoE layer weights its
    experts by the raw top-k probabilities, not renormalised to one."""
    import torch

    mods = moe_layers(model)
    for m in mods:
        def route(x, real=m.route):
            logits, probs, _, idx = real(x)
            return logits, probs, torch.gather(probs, -1, idx), idx
        m.route = route
    try:
        yield
    finally:
        for m in mods:
            del m.route


@contextlib.contextmanager
def planted_no_capacity(model):
    """A planted fault for phases 39 and 41: every MoE layer keeps every
    assignment (a capacity of S * k: no token dropped)."""
    import dataclasses

    mods = moe_layers(model)
    saved = [m.cfg for m in mods]
    for m in mods:
        m.cfg = dataclasses.replace(m.cfg, capacity_factor=float(m.cfg.n_experts))
    try:
        yield
    finally:
        for m, c in zip(mods, saved):
            m.cfg = c


#: phases 39 and 41's planted faults by model: (name, fault, gate). The
#: capacity ignored where the CPU's routing drops an assignment (else it
#: changes nothing); unnormalised gates in both dtypes for arctic-480b and
#: in float32 for kimi-k2-1t-a32b, whose top 8 of 32 experts keep most of
#: the probability beside an always-on shared expert: the fault moves its
#: hidden state by 4.0e-2 of the max, under bf16's 5e-2 (recorded there)
_NO_CAPACITY = ("no_capacity", planted_no_capacity,
                lambda dtype, flips: flips["prefill"]["dropped"] > 0)
MOE_CONTROLS = {ARCTIC: (("no_renorm", planted_no_renorm, ("float32", "bfloat16")),
                         _NO_CAPACITY),
                KIMI: (("no_renorm", planted_no_renorm, ("float32",)), _NO_CAPACITY)}


def devices_phase(torch, rg, detail, phase=12, arch=ARCH, n_layers=5, S=256, dev="cuda",
                  cfg_of=None, controls=(), T=None, routing=False) -> None:
    """Phases 12, 19, 23, 31, 35, 39 and 41: ``arch`` on the card against the CPU at
    full width and cut depth, B 1, ``S`` prompt tokens and 8 greedy steps
    (an encoder model's prompts beside ``T`` frames of ``audio_frames``,
    drawn on the card and copied to the CPU: T != S, so that a frame axis
    taken for a token axis fails; its cross caches are held as the logits),
    the same weights (drawn on the card, where a billion normals take
    milliseconds and not the host's ~10 s, and copied to the CPU), in
    float32 and bf16: the prefill's last-position logits, the final-normed
    hidden state at every position (the full logits' input: a fault in an
    earlier row shows there, not only through later layers) and the last
    decode step's logits; one RG-LRU launch per RG-LRU layer, one flash
    launch per attention layer on the blocked path (the CPU runs its twin),
    one sLSTM launch per sLSTM layer a prefill and a decode step (the CPU
    runs the plain loop) and no other kernel on the card. Each of
    ``controls`` ((name, planted fault as a context manager on the card's
    model, the dtypes it is gated
    in, or a predicate of the dtype and its record)) reruns the card's
    prefill with the fault planted and holds it to the same every-position
    check, which it must fail where it is gated. With ``routing`` (a MoE
    model) each side's routing is tapped with its inputs and held by
    ``card_cpu_routes`` in the prefill and in the last decode step (on the
    card's input every flip between the devices a near-tie, on at most
    ``FLIP_ROWS_MAX`` of the rows), and the CPU's compared runs (prefill,
    and the decode replayed on the card's tokens) take the card's routing
    (``forced_routes``): a near-tie routed the other way on the CPU's own
    input moves its row by O(1) (kimi's top 8 of 32 experts: 5% of the rows
    in bf16), so routed alike the comparison holds every position."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.launch.serve import audio_frames, generate, prompt_batch
    from repro_torch.models import init_params, prefill

    cfg_of = cfg_of or (lambda dtype: get_config(arch, n_layers=n_layers, dtype=dtype))
    B, steps = 1, 8
    ws = wrappers()
    out = {}
    for dtype, tol in (("float32", CARD_CPU_F32), ("bfloat16", CARD_CPU_BF16)):
        t0 = time.perf_counter()
        cfg = cfg_of(dtype)
        with torch.inference_mode():
            card_model = init_params(cfg, torch.Generator(device=dev).manual_seed(phase))
            cpu_model = copy.deepcopy(card_model).cpu()
            prompts = torch.randint(2, cfg.vocab, (B, S),
                                    generator=torch.Generator().manual_seed(phase))
            frames = frames_cpu = None
            if cfg.encoder_layers:
                frames = audio_frames(cfg, B, T or S,
                                      torch.Generator(device=dev).manual_seed(phase))
                frames_cpu = frames.cpu()
            hidden = {}
            tap = (functools.partial(tapped_routes, keep_x=True) if routing
                   else (lambda m: contextlib.nullcontext([])))
            _zero_launches(ws)
            with prefill_hidden(card_model, hidden, "card"), tap(card_model) as card_routes:
                toks_card, rec = generate(card_model, prompts.to(dev), steps, frames)
            card_launches = _launches(ws)
            with prefill_hidden(cpu_model, hidden, "cpu"), tap(cpu_model) as cpu_routes:
                toks_cpu, rec_cpu = generate(cpu_model, prompts, steps, frames_cpu)
            same = torch.equal(toks_card.cpu(), toks_cpu)
            # in bf16 a greedy step may pick another token at a near-tie, after
            # which the two sides decode different inputs: the CPU's last
            # logits are then taken on the card's tokens
            last_cpu = rec_cpu["last_logits"] if same or routing else decode_on(
                cpu_model, prompts, toks_card.cpu(), S + steps + 8, frames_cpu)
            flips = {}
            if routing:
                # each forward taps its MoE layers in order: the first n calls
                # are the prefill's, the last n the last decode step's
                n = len(moe_layers(cpu_model))
                for when, part in (("prefill", slice(0, n)), ("last_decode", slice(-n, None))):
                    flips[when] = card_cpu_routes(cpu_model, cpu_routes[part],
                                                  card_routes[part], dtype)
                flips["prefill"].update(dropped=sum(int((~c["kept"]).sum())
                                                    for c in cpu_routes[:n]),
                                        ties=sum(c["ties"] for c in cpu_routes[:n]))
                # the CPU's compared runs take the card's routing, so that the
                # two sides' outputs are continuous in their inputs and
                # compare at every position
                hidden.pop("cpu")
                batch_cpu = prompt_batch(cpu_model, prompts, frames_cpu)
                with forced_routes(cpu_model, card_routes[:n]), \
                        prefill_hidden(cpu_model, hidden, "cpu"):
                    rec_cpu = dict(rec_cpu, logits=prefill(cpu_model, batch_cpu,
                                                           S + steps + 8)[1])
                with forced_routes(cpu_model, card_routes):
                    last_cpu = decode_on(cpu_model, prompts, toks_card.cpu(), S + steps + 8,
                                         frames_cpu)
            del card_routes, cpu_routes
            cross = {}
            if cfg.encoder_layers:
                caches = [prefill(m, prompt_batch(m, p, f), S + steps + 8)[0]["cross"]
                          for m, p, f in ((card_model, prompts.to(dev), frames),
                                          (cpu_model, prompts, frames_cpu))]
                for i, (a, b) in enumerate(zip(*caches)):
                    for k in ("ck", "cv"):
                        check(tuple(a[k].shape) == (B, T or S, cfg.n_kv_heads,
                                                    cfg.resolved_head_dim),
                              f"{arch} {dtype}: layer {i} {k} of shape {tuple(a[k].shape)}")
                        cross[f"{i}/{k}"] = rel_err(a[k].cpu(), b[k])
                del caches
            planted = {}
            for name, plant, _gated in controls:
                got = {}
                with plant(card_model), prefill_hidden(card_model, got, "card"):
                    _, logits = prefill(card_model, prompt_batch(card_model, prompts.to(dev),
                                                                 frames),
                                        S + steps + 8)
                planted[name] = {
                    "rel_err_all_positions": rel_err(got["card"].cpu(), hidden["cpu"]),
                    "rel_err_last_position": rel_err(logits.cpu(), rec_cpu["logits"])}
        errs = []
        for key, a, b in (("logits", rec["logits"], rec_cpu["logits"]),
                          ("hidden", hidden["card"], hidden["cpu"]),
                          ("last_logits", rec["last_logits"], last_cpu)):
            a = a.cpu()
            check(bool(torch.isfinite(a).all()), f"{arch} {dtype}: card {key} not finite")
            errs.append(rel_err(a, b))
        err, err_all, err_dec = errs
        n_rglru, flash = rglru_layers(cfg)[1], blocked_layers(cfg)
        n_slstm = slstm_layers(cfg)[1] * (1 + steps)  # the prefill and each step
        check(card_launches == _want(ws, rglru_scan=n_rglru, flash_attention=flash,
                                     slstm_scan=n_slstm),
              f"{arch} {dtype}: kernel launches {card_launches}, want {n_rglru} RG-LRU, "
              f"{flash} flash and {n_slstm} sLSTM launches and no other")
        check(err <= tol, f"{arch} {dtype}: card vs CPU prefill logits {err:.3e} > {tol:g}")
        check(err_all <= tol, f"{arch} {dtype}: card vs CPU prefill hidden state at every "
              f"position {err_all:.3e} > {tol:g}")
        check(err_dec <= tol, f"{arch} {dtype}: card vs CPU logits of the last decode "
              f"step {err_dec:.3e} > {tol:g}")
        for when, f in flips.items():
            check(f["unjustified"] == 0 and f["kept_unexplained"] == 0,
                  f"{arch} {dtype}: {when}: on the card's MoE inputs {f['unjustified']} of "
                  f"{f['device_tokens']} routing flips between the devices are not near-ties, "
                  f"{f['kept_unexplained']} of {f['kept_diff']} kept flags differ behind no "
                  f"flip")
            check(f["device_rows"] <= FLIP_ROWS_MAX * f["rows_of"],
                  f"{arch} {dtype}: {when}: routing flips between the devices change "
                  f"{f['device_rows']} of {f['rows_of']} rows (> {FLIP_ROWS_MAX:.0%})")
        err_cross = max(cross.values(), default=0.0)
        check(err_cross <= tol, f"{arch} {dtype}: card vs CPU cross caches {err_cross:.3e} "
              f"> {tol:g} ({cross})")
        for name, _plant, gated in controls:
            on = gated(dtype, flips) if callable(gated) else dtype in gated
            planted[name]["gated"] = on
            check(not on or planted[name]["rel_err_all_positions"] > tol,
                  f"{arch} {dtype}: the planted fault {name!r} passes the every-position "
                  f"check ({planted[name]['rel_err_all_positions']:.3e} <= {tol:g})")
        if dtype == "float32":
            check(same, f"{arch} float32: card tokens {toks_card.tolist()} vs CPU "
                  f"{toks_cpu.tolist()}")
        out[dtype] = {"rel_err": err, "rel_err_all_positions": err_all,
                      "rel_err_last_decode": err_dec, "planted": planted,
                      "frames": (T or S) if cfg.encoder_layers else None,
                      "rel_err_cross": cross, "routing": flips,
                      "tokens_equal": same, "last_decode_on_card_tokens": not same,
                      "launches": n_rglru, "flash_launches": flash,
                      "slstm_launches": n_slstm, "card_tokens": toks_card.tolist(),
                      "cpu_tokens": toks_cpu.tolist(),
                      "seconds": time.perf_counter() - t0}
        log(f"[{phase}] {cfg.name} n_layers={cfg.n_layers} ({', '.join(card_model.kinds)}; "
            f"{cfg.attention_impl} attention) {dtype}, {B} x {S} + {steps} steps: card vs "
            f"CPU logits, prefill {err:.3e}, hidden state at every position {err_all:.3e}, "
            f"last decode step {err_dec:.3e} (<= {tol:g}); "
            + (f"{T or S} frames, cross caches {err_cross:.3e}; " if cross else "")
            + f"greedy tokens {'identical' if same else 'differ: the CPU decoded the card tokens'}"
            f"; kernel launches: RG-LRU {n_rglru}, flash {flash}, sLSTM {n_slstm}, no other "
            f"({out[dtype]['seconds']:.1f} s)")
        for when, f in flips.items():
            log(f"    routing, {when}: on the card's MoE input the CPU routes "
                f"{f['device_tokens']} tokens to another set of experts, all within the "
                f"near-tie margin ({f['device_rows']} of {f['rows_of']} rows; "
                f"{f['device_reordered']} more in another order), {f['kept_diff']} kept flags "
                f"moved behind them; on its own input, {f['tokens']} tokens ({f['pairs']} "
                f"experts swapped, {f['n_rows']} rows; {f['reordered']} reordered); compared "
                f"routed as the card"
                + (f"; the CPU dropped {f['dropped']} assignments, {f['ties']} tokens tie "
                   f"exactly at the top-k boundary" if "dropped" in f else ""))
        for name, ctl in planted.items():
            log(f"    planted fault {name!r} on the card: hidden state at every position "
                f"{ctl['rel_err_all_positions']:.3e}, last-position logits "
                f"{ctl['rel_err_last_position']:.3e} (tolerance {tol:g}"
                f"{'' if ctl['gated'] else '; not gated here'})")
        del cpu_model, card_model
    detail[f"card_vs_cpu_{run_key(arch, cfg)}"] = out


def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """The (query, key) pairs the attention mask lets through, per head."""
    n = 0
    for q in range(Sq):
        lo = 0 if window is None else max(0, q - window + 1)
        hi = min(Sk, q + 1) if causal else Sk
        n += max(0, hi - lo)
    return n


#: full-width attention shapes of phase 13: (label, B, Hq, Hkv, S, D,
#: causal, window). First the three that phase 30's blocked prefills (8
#: prompts of 2048) give the kernel: yi-9b's layers (configs/yi_9b.py: 32
#: query heads, 4 KV heads of 128), whose times the kernels line reports
#: and where the float32 path is timed, and gemma3-4b's sliding (window
#: 1024) and full layers (configs/gemma3_4b.py: 8 query heads, 4 KV heads
#: of 256). Then arctic-480b's layers in phase 38's blocked prefill
#: (configs/arctic_480b.py: 56 query heads, 8 KV heads of 128, so 7 query
#: heads a KV head). Then recurrentgemma-2b's sliding layer at its serve
#: cell (10 query heads, 1 KV head of 256, window 2048) and gemma3-4b's
#: sliding layer at B 4, S 4096, which no model path runs (kept as earlier
#: measurements' shapes).
FLASH_FULL = (("flash_yi9b_b8_s2048", 8, 32, 4, 2048, 128, True, None),
              ("flash_gemma3_4b_b8_s2048_w1024", 8, 8, 4, 2048, 256, True, 1024),
              ("flash_gemma3_4b_b8_s2048_full", 8, 8, 4, 2048, 256, True, None),
              ("flash_arctic_b8_s2048", 8, 56, 8, 2048, 128, True, None),
              ("flash_rgemma2b_b8_s2048", 8, 10, 1, 2048, 256, True, 2048),
              ("flash_gemma3_4b_b4_s4096_w1024", 4, 8, 4, 4096, 256, True, 1024))


#: phase 13's offset shapes, the kernel at a query offset as phase 49's
#: prefill split over two ranks calls it: rank 1's block of 8 prompts of
#: 2048 (its 1024 query rows at positions 1024-2047, every key), (label, B,
#: Hq, Hkv, Sq, Sk, D, window, q_offset), causal: gemma3-4b's sliding layer
#: (window 1024) and yi-9b's layers
FLASH_OFFSET = (("flash_gemma3_4b_rank1_w1024", 8, 8, 4, 1024, 2048, 256, 1024, 1024),
                ("flash_yi9b_rank1", 8, 32, 4, 1024, 2048, 128, None, 1024))
#: small offset cases of phase 13 beside them (B, Hq, Hkv, Sq, Sk, D, window,
#: q_offset): ragged tiles, a window edge inside a tile, rows that see no
#: key, an offset that is no multiple of a tile
FLASH_OFFSET_CASES = ((1, 2, 2, 200, 456, 64, 100, 256), (2, 4, 2, 128, 384, 128, None, 256),
                      (1, 2, 1, 96, 160, 256, 32, 64), (1, 2, 2, 64, 64, 64, 16, 200))


def offset_pairs(Sq: int, Sk: int, window, q_offset: int) -> int:
    """The causal (query, key) pairs, per head, of query rows at positions
    q_offset .. q_offset + Sq - 1 against keys 0 .. Sk - 1."""
    n = 0
    for q in range(q_offset, q_offset + Sq):
        lo = 0 if window is None else max(0, q - window + 1)
        n += max(0, min(Sk, q + 1) - lo)
    return n


def kernel_report(name: str) -> dict:
    """Per kernel function of the built library ``csrc/<name>.cu``: ptxas's
    registers and spill line (when this process built it) and the count of
    each SASS opcode in ``SASS_OPS``, from ``cuobjdump -sass``."""
    import re

    from repro_torch.kernels import _build

    path = _build.build(name)
    report, fn = {}, None
    for line in _build.BUILD_LOG.get(path, "").splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
        elif fn and "registers" in line:
            report[fn]["registers"] = line.split(":", 1)[-1].strip()
        elif fn and "spill" in line:
            report[fn]["spills"] = line.split(":", 1)[-1].strip()
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
        elif fn:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    report[fn][op] = report[fn].get(op, 0) + 1
    return report


def kernel_name(mangled: str) -> str:
    """``flash_tc_kernel<256>`` / ``flash_kernel<bf16, 64>`` /
    ``waterfill_solve_kernel<true>`` / ``pd_segment_kernel`` /
    ``rglru_scan_tma_kernel<float>`` for a mangled kernel name; other names
    as they are."""
    import re

    m = re.search(r"(rglru_scan(?:_backward)?(?:_tma)?_kernel)(?:I(f|13__nv_bfloat16))?",
                  mangled)
    if m:
        dtype = {"f": "<float>", "13__nv_bfloat16": "<bf16>"}.get(m.group(2) or "", "")
        return m.group(1) + dtype
    m = re.search(r"waterfill_solve_kernelILb([01])E", mangled)
    if m:
        return f"waterfill_solve_kernel<{'true' if m.group(1) == '1' else 'false'}>"
    if "pd_segment_kernel" in mangled:
        return "pd_segment_kernel"
    m = re.search(r"(flash_(?:tc_)?kernel)I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m.group(2) or "", "")
    return f"{m.group(1)}<{dtype}{m.group(3)}>"


#: SASS opcodes counted by ``kernel_report``: the flash tensor-core kernel
#: must hold the warpgroup products (HGMMA) and TMA tile loads (UTMALDG),
#: the RG-LRU TMA kernels the TMA loads.
SASS_OPS = ("HGMMA", "UTMALDG")


def flash_phase(torch, fa, detail, dev="cuda") -> dict:
    """Phase 13: the flash attention kernels against their plain version
    through ``ops.flash_attention`` / ``flash_attention_gqa``, one launch per
    call on the path ``_path_for`` names (bf16 with D % 8 == 0 and aligned
    operands on the tensor-core kernel, the rest on the CUDA-core one), the
    grad guard of the three workload wrappers, the tensor-core kernel's
    SASS, and each ``FLASH_FULL`` shape held to the plain version and SDPA
    and timed. Returns the first shape's numbers (yi-9b's) and, as
    ``max_abs_err``, the worst of the full-width shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_mask

    g = torch.Generator(device=dev).manual_seed(13)

    def operands(B, Hq, Hkv, Sq, Sk, D, dtype, misaligned=False):
        shapes = ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))
        if not misaligned:
            return tuple(torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes)
        # contiguous views one element into their buffers: 2-byte aligned
        return tuple(torch.randn(math.prod(s) + 1, generator=g, device=dev).to(dtype)[1:]
                     .view(s) for s in shapes)

    def op_call(q, k, v, tc, **kw):
        before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
        op = ops.flash_attention if q.shape[1] == k.shape[1] else ops.flash_attention_gqa
        out = op(q, k, v, **kw)
        check(fa.flash_attention.launches == before + 1,
              f"{fa.flash_attention.launches - before} launches for one op call")
        took = fa.flash_attention.launches_tc - before_tc
        check(took == int(tc), f"{tuple(q.shape)} {q.dtype}: {took} tensor-core launches, "
              f"want {int(tc)}")
        return out

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []  # (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, misaligned)
    for B, H, S, D in ((1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128),
                       (2, 2, 384, 32)):
        cases += [(B, H, H, S, S, D, dt, c, None) for dt in (f32, bf16)
                  for c in (True, False)]
    cases += [(1, 2, 2, 512, 512, 64, f32, True, w) for w in (64, 128, 256)]
    cases += [(2, 8, 2, 256, 256, 64, f32, True, None),   # GQA
              (1, 2, 2, 256, 384, 64, f32, True, None),   # Sq != Sk
              (1, 2, 2, 128, 512, 64, f32, False, 128),   # Sq != Sk, window only
              (1, 2, 2, 256, 128, 64, f32, True, 64),     # rows q >= 191 see no key
              (1, 2, 2, 256, 256, 256, f32, True, None),  # D = 256
              (1, 4, 2, 256, 256, 256, bf16, False, 128),
              # ragged query and key tiles, D below the kernel's tile width
              (1, 2, 2, 80, 144, 48, f32, True, None),
              (2, 3, 1, 208, 112, 80, bf16, False, 48),
              (1, 2, 2, 48, 48, 256, f32, True, 16)]
    cases = [c + (False,) for c in cases]
    # the tensor-core kernel's edges, and bf16 it does not take
    cases += [(1, 2, 2, 2048, 2048, 256, bf16, True, None, False),  # tiles on the diagonal
              (1, 2, 2, 512, 512, 128, bf16, True, 100, False),     # window edge in a tile
              (2, 10, 1, 256, 256, 256, bf16, True, None, False),   # GQA 10 / 1
              (1, 2, 2, 192, 200, 64, bf16, False, None, False),    # Sk % 64 != 0
              (1, 2, 2, 300, 700, 128, bf16, True, None, False),    # Sq != Sk, both ragged
              (1, 2, 2, 256, 256, 32, bf16, True, 96, False),       # D = 32
              (1, 2, 2, 256, 128, 64, bf16, True, 64, False),       # rows that see no key
              (1, 2, 2, 256, 256, 64, bf16, True, None, True),      # misaligned view
              (1, 2, 2, 128, 128, 36, bf16, True, None, False)]     # D % 8 != 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_tc = 0
    for B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, misaligned in cases:
        q, k, v = operands(B, Hq, Hkv, Sq, Sk, D, dtype, misaligned)
        tc = dtype == bf16 and D % 8 == 0 and not misaligned
        n_tc += tc
        # the op's blocks only refuse lengths they do not divide
        got = op_call(q, k, v, tc, causal=causal, window=window,
                      block_q=math.gcd(Sq, 16), block_k=math.gcd(Sk, 16))
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        what = (f"flash {(B, Hq, Hkv, Sq, Sk, D)} {dtype} causal={causal} window={window}"
                f"{' misaligned' if misaligned else ''}")
        check(got.dtype == dtype and tuple(got.shape) == (B, Hq, Sq, D),
              f"{what}: got {got.dtype} {tuple(got.shape)}")
        key = str(dtype).split(".")[1]
        tol = FLASH_TOL[key]
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol,
                                   msg=lambda m: f"{what}: {m}")
        worst[key] = max(worst[key], float((got.float() - ref.float()).abs().max()))
        del q, k, v, got, ref
    log(f"[13] flash_attention kernels == plain on {len(cases)} cases ({n_tc} on the "
        f"tensor-core kernel, {len(cases) - n_tc} on the CUDA-core one), 1 launch per "
        f"op call on the expected path; max |diff| fp32 {worst['float32']:.3e} (tol "
        f"{FLASH_TOL['float32']:g}), bf16 {worst['bfloat16']:.3e} (tol "
        f"{FLASH_TOL['bfloat16']:g})")

    # flash attention and the cross-entropy have no backward: an input that
    # requires grad must raise
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import xent as xe

    q, k, v = operands(1, 2, 2, 128, 128, 64, bf16)
    logits = torch.randn((4, 64), generator=g, device=dev)
    calls = (("flash_attention", fa.flash_attention,
              lambda: ops.flash_attention(q.clone().requires_grad_(), k, v)),
             ("softmax_xent", xe.softmax_xent, lambda: ops.softmax_xent(
                 logits.clone().requires_grad_(),
                 torch.zeros(4, dtype=torch.int64, device=dev))))
    for name, wrapper, call in calls:
        before = wrapper.launches
        try:
            call()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        check("no backward" in raised and wrapper.launches == before,
              f"{name} on an input that requires grad: {raised or 'no error'}")
    # the RG-LRU scan has one: grad flows through its two kernels
    a = torch.rand((1, 8, 16), generator=g, device=dev)
    a_grad = a.clone().requires_grad_()
    before = (rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
    ops.rglru_scan(a_grad, a, torch.zeros((1, 16), device=dev)).sum().backward()
    after = (rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
    h = rg.rglru_scan_plain(a, a, torch.zeros((1, 16), device=dev))
    want = rg.rglru_scan_backward_plain(a, h, torch.zeros((1, 16), device=dev),
                                        torch.ones_like(a))[0]
    check(after == (before[0] + 1, before[1] + 1) and a_grad.grad is not None
          and torch.equal(a_grad.grad, want),
          f"rglru_scan with grad: launches {before} -> {after}, grad {a_grad.grad}")
    log(f"    {', '.join(c[0] for c in calls)}: an input that requires grad raises, "
        f"no launch; rglru_scan: grad flows through its forward and backward "
        f"kernels (1 launch each)")

    report = kernel_report("flash_attention")
    tc_fns = {f: r for f, r in report.items() if "flash_tc_kernel" in f}
    check(len(tc_fns) >= 1 and all(r.get("HGMMA", 0) and r.get("UTMALDG", 0)
                                   for r in tc_fns.values()),
          f"the tensor-core kernel's SASS lacks HGMMA or UTMALDG: {tc_fns}")
    for f, r in sorted(report.items()):
        if "flash" in f:
            log(f"    {kernel_name(f)}: {r.get('registers', 'ptxas report not kept')}; "
                f"{r.get('spills', '')}; " + ", ".join(f"{op} {r.get(op, 0)}"
                                                        for op in SASS_OPS))
    detail["flash_kernel_build"] = report

    full = {}
    ins = {label: operands(B, Hq, Hkv, S, S, D, bf16)
           for label, B, Hq, Hkv, S, D, _c, _w in FLASH_FULL}
    # the main path: one op call at each full-width shape
    fa.flash_attention.launches = 0
    fa.flash_attention.launches_tc = 0
    outs = {label: op_call(*ins[label], True, causal=c, window=w)
            for label, *_shape, c, w in FLASH_FULL}
    torch.cuda.synchronize()
    launches, launches_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    check(launches == launches_tc == len(FLASH_FULL),
          f"{launches} launches ({launches_tc} tensor-core) for {len(FLASH_FULL)} calls")
    for label, B, Hq, Hkv, S, D, causal, window in FLASH_FULL:
        q, k, v = ins[label]
        got = outs[label]
        check(torch.equal(got, fa._launch(q, k, v, causal, window)),
              f"{label}: a second launch differs from the first")
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, ref, atol=FLASH_TOL["bfloat16"],
                                   rtol=FLASH_TOL["bfloat16"])
        err = float((got.float() - ref.float()).abs().max())
        del ref
        # SDPA's own causal form where the window hides nothing, else a mask
        mask = (None if window is None or window >= S
                else attention_mask(S, S, causal, window, dev))

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        torch.testing.assert_close(library(), got, atol=FLASH_TOL["bfloat16"],
                                   rtol=FLASH_TOL["bfloat16"])
        t = {"max_abs_err": err,
             "kernel_ms": graph_ms(torch, lambda: fa._launch(q, k, v, causal, window),
                                   reps=10, rounds=3),
             "call_ms": call_ms(torch, lambda: ops.flash_attention_gqa(
                 q, k, v, causal=causal, window=window), reps=20),
             "plain_ms": graph_ms(torch, lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal, window=window), reps=1, rounds=2),
             "library_ms": graph_ms(torch, library, reps=10, rounds=3)}
        pairs = visible_pairs(S, S, causal, window) * B * Hq
        n_bytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
        t["gflop"] = 4 * D * pairs / 1e9
        t["tflops"] = t["gflop"] / t["kernel_ms"]
        t["bound_ms"], t["bound_by"] = bound(n_bytes, 4 * D * pairs, BF16_TC_FLOPS)
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        full[label] = t
        log(f"    {label}: tensor-core kernel {t['kernel_ms']:.4f} ms (graph replay; "
            f"{t['call_ms']:.4f} ms per op call), {t['tflops']:.1f} TFLOP/s, "
            f"{t['bound_share']:.1%} of the bound; plain {t['plain_ms']:.3f} ms, "
            f"SDPA {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {t['gflop']:.1f} GFLOP, {n_bytes / 1e6:.0f} MB); "
            f"max |diff| vs plain {err:.3e}; a second launch identical")
        del got, mask
    del ins, outs

    # the float32 path (the CUDA-core kernel) at the first full-width shape
    label, B, Hq, Hkv, S, D, causal, window = FLASH_FULL[0]
    q, k, v = operands(B, Hq, Hkv, S, S, D, f32)
    before_tc = fa.flash_attention.launches_tc
    got = fa._launch(q, k, v, causal, window)
    check(fa.flash_attention.launches_tc == before_tc, "float32 took the tensor-core path")
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, ref, atol=FLASH_TOL["float32"], rtol=FLASH_TOL["float32"])
    fp32 = {"max_abs_err": float((got - ref).abs().max()),
            "kernel_ms": graph_ms(torch, lambda: fa._launch(q, k, v, causal, window),
                                  reps=3, rounds=2)}
    fp32["tflops"] = full[label]["gflop"] / fp32["kernel_ms"]
    log(f"    {label} float32: CUDA-core kernel {fp32['kernel_ms']:.3f} ms "
        f"({fp32['tflops']:.1f} TFLOP/s), max |diff| vs plain {fp32['max_abs_err']:.3e}")
    del q, k, v, got, ref

    # the kernels at a query offset (a sequence block's rows): small cases,
    # then rank 1's blocks of phase 49's gemma3-4b and of yi-9b, both kernels
    # held to the plain version, the tensor-core one timed beside SDPA on
    # the same boolean mask
    offset_worst = {"float32": 0.0, "bfloat16": 0.0}
    n_offset = 0
    for B, Hq, Hkv, Sq, Sk, D, window, off in FLASH_OFFSET_CASES:
        for dtype in (f32, bf16):
            q, k, v = operands(B, Hq, Hkv, Sq, Sk, D, dtype)
            tc = dtype == bf16 and D % 8 == 0
            got = op_call(q, k, v, tc, causal=True, window=window, block_q=math.gcd(Sq, 16),
                          block_k=math.gcd(Sk, 16), q_offset=off)
            ref = fa.flash_attention_plain(q, k, v, causal=True, window=window, q_offset=off)
            key = str(dtype).split(".")[1]
            torch.testing.assert_close(got, ref, atol=FLASH_TOL[key], rtol=FLASH_TOL[key],
                                       msg=lambda m: f"flash {(B, Hq, Hkv, Sq, Sk, D)} "
                                       f"{dtype} window={window} q_offset={off}: {m}")
            offset_worst[key] = max(offset_worst[key], float((got.float() - ref.float())
                                                             .abs().max()))
            n_offset += 1
            del q, k, v, got, ref
    offset = {}
    for olabel, B, Hq, Hkv, Sq, Sk, D, window, off in FLASH_OFFSET:
        t = {"q_offset": off, "shape": [B, Hq, Hkv, Sq, Sk, D], "window": window}
        for dtype in (bf16, f32):
            key = str(dtype).split(".")[1]
            q, k, v = operands(B, Hq, Hkv, Sq, Sk, D, dtype)
            got = op_call(q, k, v, dtype == bf16, causal=True, window=window, q_offset=off,
                          block_q=math.gcd(Sq, 16), block_k=math.gcd(Sk, 16))
            ref = fa.flash_attention_plain(q, k, v, causal=True, window=window, q_offset=off)
            torch.testing.assert_close(got, ref, atol=FLASH_TOL[key], rtol=FLASH_TOL[key],
                                       msg=lambda m: f"{olabel} {key}: {m}")
            t[f"max_abs_err_{key}"] = float((got.float() - ref.float()).abs().max())
            offset_worst[key] = max(offset_worst[key], t[f"max_abs_err_{key}"])
            del ref
            if dtype == f32:
                t["fp32_kernel_ms"] = graph_ms(torch, lambda: fa._launch(
                    q, k, v, True, window, off), reps=3, rounds=2)
                del q, k, v, got
                continue
            mask = attention_mask(Sq, Sk, True, window, dev, off)

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)

            torch.testing.assert_close(library(), got, atol=FLASH_TOL["bfloat16"],
                                       rtol=FLASH_TOL["bfloat16"])
            t["kernel_ms"] = graph_ms(torch, lambda: fa._launch(q, k, v, True, window, off),
                                      reps=10, rounds=3)
            t["plain_ms"] = graph_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True, window=window, q_offset=off), reps=1, rounds=2)
            t["library_ms"] = graph_ms(torch, library, reps=10, rounds=3)
            pairs = offset_pairs(Sq, Sk, window, off) * B * Hq
            n_bytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
            t["gflop"] = 4 * D * pairs / 1e9
            t["tflops"] = t["gflop"] / t["kernel_ms"]
            t["bound_ms"], t["bound_by"] = bound(n_bytes, 4 * D * pairs, BF16_TC_FLOPS)
            t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
            del q, k, v, got, mask
        t["fp32_tflops"] = t["gflop"] / t["fp32_kernel_ms"]
        offset[olabel] = t
        log(f"    {olabel} (q_offset {off}): tensor-core kernel {t['kernel_ms']:.4f} ms "
            f"(graph replay), {t['tflops']:.1f} TFLOP/s, {t['bound_share']:.1%} of the bound; "
            f"CUDA-core kernel (float32) {t['fp32_kernel_ms']:.3f} ms "
            f"({t['fp32_tflops']:.1f} TFLOP/s); plain {t['plain_ms']:.3f} ms, SDPA (the same "
            f"boolean mask) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {t['gflop']:.1f} GFLOP); max |diff| vs plain bf16 "
            f"{t['max_abs_err_bfloat16']:.3e}, fp32 {t['max_abs_err_float32']:.3e}")
    log(f"    at a query offset: both kernels == plain on {n_offset} small cases and the "
        f"{len(FLASH_OFFSET)} rank-1 blocks; max |diff| fp32 {offset_worst['float32']:.3e}, "
        f"bf16 {offset_worst['bfloat16']:.3e}")

    detail["flash_kernel"] = {"cases": len(cases), "tensor_core_cases": n_tc,
                              "max_abs_err": worst, "launches": launches,
                              "launches_tc": launches_tc, "full_width": full,
                              "float32_" + label: fp32, "offset": offset,
                              "offset_cases": n_offset, "offset_max_abs_err": offset_worst}
    return {**full[label], "launches": launches, "launches_tc": launches_tc,
            "fp32_ms": fp32["kernel_ms"],
            "max_abs_err": max(t["max_abs_err"] for t in full.values()),
            "max_abs_err_cases": max(worst.values()), "offset": offset}


#: full-width cross-entropy shapes of phase 14: (label, N, V). One chunk of
#: the training loss (``logits_chunk`` 512 at batch 8) for gemma3-4b's
#: 262,144 vocab and recurrentgemma-2b's 256,000.
XENT_FULL = (("xent_gemma3_4b_n4096_v262144", 4096, 262144),
             ("xent_rgemma2b_n4096_v256000", 4096, 256000))


def xent_phase(torch, xe, detail, dev="cuda") -> dict:
    """Phase 14: the cross-entropy kernel against its plain version through
    ``ops.softmax_xent``, one launch per call, and its times at two
    full-width shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(14)

    def operands(N, V, dtype, tdtype=torch.int32, edge=False):
        logits = (3 * torch.randn((N, V), generator=g, device=dev)).to(dtype)
        targets = torch.randint(0, V, (N,), generator=g, device=dev, dtype=tdtype)
        if edge:  # targets outside [0, V): the loss is the logsumexp
            targets[0::2] = -1
            targets[1::4] = V
        return logits, targets

    def op_call(logits, targets):
        before = xe.softmax_xent.launches
        out = ops.softmax_xent(logits, targets)
        check(xe.softmax_xent.launches == before + 1,
              f"{xe.softmax_xent.launches - before} launches for one op call")
        return out

    f32, bf16, i64 = torch.float32, torch.bfloat16, torch.int64
    cases = [((256, 4096), f32, {}), ((128, 51968), bf16, {}), ((64, 1000), f32, {}),
             ((32, 262144), bf16, {}), ((64, 50257), bf16, {}), ((1, 4096), f32, {}),
             ((1, 1), f32, {}), ((8, 4099), f32, {}),
             ((96, 51968), bf16, {"tdtype": i64}),
             ((64, 1000), f32, {"edge": True}), ((16, 50257), bf16, {"edge": True})]
    worst = 0.0
    for (N, V), dtype, kw in cases:
        logits, targets = operands(N, V, dtype, **kw)
        got = op_call(logits, targets)
        ref = xe.softmax_xent_plain(logits, targets)
        torch.cuda.synchronize()
        what = f"xent {(N, V)} {dtype} {kw}"
        check(got.dtype == f32 and tuple(got.shape) == (N,), f"{what}: {got.dtype}")
        torch.testing.assert_close(got, ref, atol=XENT_ATOL, rtol=XENT_RTOL,
                                   msg=lambda m: f"{what}: {m}")
        if kw.get("edge"):
            lse = torch.logsumexp(logits.float(), -1)
            outside = (targets < 0) | (targets >= V)
            torch.testing.assert_close(got[outside], lse[outside], atol=XENT_ATOL,
                                       rtol=XENT_RTOL)
        worst = max(worst, float((got - ref).abs().max()))
        del logits, targets, got, ref
    log(f"[14] softmax_xent kernel == plain on {len(cases)} cases (atol {XENT_ATOL:g}, "
        f"rtol {XENT_RTOL:g}), 1 launch per op call, max |diff| {worst:.3e}")

    full = {}
    ins = {label: operands(N, V, bf16, tdtype=i64) for label, N, V in XENT_FULL}
    # the main path: one op call at each full-width shape
    xe.softmax_xent.launches = 0
    outs = {label: op_call(*ins[label]) for label, _N, _V in XENT_FULL}
    torch.cuda.synchronize()
    launches = xe.softmax_xent.launches
    check(launches == len(XENT_FULL), f"{launches} launches for {len(XENT_FULL)} calls")
    for label, N, V in XENT_FULL:
        logits, targets = ins[label]
        got = outs[label]
        ref = xe.softmax_xent_plain(logits, targets)
        torch.testing.assert_close(got, ref, atol=XENT_ATOL, rtol=XENT_RTOL)
        err = float((got - ref).abs().max())
        del ref

        def library():
            return F.cross_entropy(logits.float(), targets, reduction="none")

        torch.testing.assert_close(library(), got, atol=XENT_ATOL, rtol=XENT_RTOL)
        t = {"max_abs_err": err,
             "kernel_ms": graph_ms(torch, lambda: xe._launch(logits, targets),
                                   reps=10, rounds=3),
             "call_ms": call_ms(torch, lambda: ops.softmax_xent(logits, targets),
                                reps=20),
             "plain_ms": graph_ms(torch, lambda: xe.softmax_xent_plain(logits, targets),
                                  reps=1, rounds=2),
             "library_ms": graph_ms(torch, library, reps=1, rounds=2)}
        n_bytes = N * V * 2 + N * 8 + N * 4
        t["bound_ms"], t["bound_by"] = bound(n_bytes, 4 * N * V, FP32_FLOPS)
        full[label] = t
        log(f"    {label}: kernel {t['kernel_ms']:.3f} ms (graph replay; "
            f"{t['call_ms']:.3f} ms per op call), plain {t['plain_ms']:.3f} ms, "
            f"F.cross_entropy {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}, {n_bytes / 1e9:.2f} GB); max |diff| vs plain {err:.3e}")
        del got
    del ins, outs
    worst_all = max(worst, *(t["max_abs_err"] for t in full.values()))
    detail["xent_kernel"] = {"cases": len(cases), "max_abs_err": worst,
                             "launches": launches, "full_width": full}
    return {"max_abs_err": worst_all, "launches": launches, **full[XENT_FULL[0][0]]}


def rglru_backward_phase(torch, rg, detail, dev="cuda") -> dict:
    """Phase 15: the RG-LRU backward kernels against their plain version,
    bit for bit, on the route ``_route`` names and, where that is the TMA
    kernel, on the direct one too; grad through the autograd Function
    against autograd of the plain forward; and both kernels' times at the
    training shape (2, 2048, 2560)."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(15)
    f32 = torch.float32

    def operands(shape, h0_zero, misaligned=False):
        a, b, h0, dh = rglru_operands(torch, g, dev, shape, f32, h0_zero, misaligned,
                                      grad=True)
        with torch.no_grad():
            h = rg.rglru_scan(a, b, h0)
        return a, b, h0, h, dh

    B, S, D = TRAIN_SHAPE
    T = RG_TILE
    # (shape, h0 = 0, misaligned views)
    cases = [((B, S, D), True, False),  # the training shape
             (sched_rglru_shape(), True, False),  # phase 26's tenant
             ((1, 64, 32), False, False), ((2, 128, 64), False, False),
             ((3, 192, 128), False, False), ((3, 256, 256), False, False),
             ((1, 128, 2568), False, False), ((1, 130, 2564), False, False),
             ((2, 1, 2560), False, False), ((2, 17, 96), False, False),
             ((2, T - 1, 256), False, False), ((2, T + 1, 256), False, False),
             ((1, 4097, 256), False, False), ((3, 200, 32), False, False),
             ((2, 70, 97), False, False),  # D % 4 != 0
             ((2, 129, 256), False, True)]  # misaligned views
    runs = {"tma": 0, "direct": 0}
    max_err = 0.0
    for shape, h0_zero, misaligned in cases:
        a, _, h0, h, dh = operands(shape, h0_zero, misaligned)
        route = rglru_route(torch, f32, shape[2], misaligned)
        what = f"rglru_scan_backward {shape}{' misaligned' if misaligned else ''}"
        want = rg.rglru_scan_backward_plain(a, h, h0, dh)
        w = rg.rglru_scan_backward
        before = (w.launches, w.launches_tma)
        outs = {route: rg.rglru_scan_backward(a, h, h0, dh)}
        took = (w.launches - before[0], w.launches_tma - before[1])
        check(took == (1, int(route == "tma")),
              f"{what}: {took[0]} launches, {took[1]} on the TMA kernel; want the {route} route")
        if route == "tma":
            outs["direct"] = rg._launch_backward(a, h, h0, dh, route="direct")
            check(w.launches_tma == before[1] + 1,
                  f"{what}: the direct route counted a TMA launch")
        torch.cuda.synchronize()
        for r, got in outs.items():
            for name, x, y in zip(("da", "db", "dh0"), got, want):
                check(x.dtype == f32 and x.shape == y.shape,
                      f"{what} {name}: {x.dtype} {tuple(x.shape)}")
                err = float((x - y).abs().max())
                check(torch.equal(x, y), f"{what}: {name} of the {r} kernel differs "
                      f"from the plain version (max |diff| {err:.3e})")
                max_err = max(max_err, err)
            runs[r] += 1
        del a, h0, h, dh, want, outs
    # grad through the Function (both kernels) against autograd of the plain
    # forward, at small shapes, float32
    grad_err = 0.0
    for shape in ((2, 64, 96), (1, 300, 40), (3, 1, 8)):
        a, b, h0, _, dh = operands(shape, False)
        xs = [t.clone().requires_grad_() for t in (a, b, h0)]
        ys = [t.clone().requires_grad_() for t in (a, b, h0)]
        before = (rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
        ops.rglru_scan(*xs).backward(dh)
        check((rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
              == (before[0] + 1, before[1] + 1), "grad did not go through both kernels")
        rg.rglru_scan_plain(*ys).backward(dh)
        for x, y in zip(xs, ys):
            torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-4)
            grad_err = max(grad_err, float((x.grad - y.grad).abs().max()))
    log(f"[15] rglru_scan_backward kernels == plain bit for bit on {len(cases)} cases "
        f"({runs['tma']} runs on the TMA kernel, {runs['direct']} on the direct one), one "
        f"launch per call on the expected route; grad through both kernels vs autograd "
        f"of the plain forward {grad_err:.3e} (atol 1e-5)")
    a, b, h0, h, dh = operands((B, S, D), True)
    n = B * S * D
    t = dict(zip(("bound_ms", "bound_by"), bound(5 * n * 4 + 2 * B * D * 4, 3 * n + B * D,
                                                 FP32_FLOPS)))
    for r, call in (("tma", lambda: rg.rglru_scan_backward(a, h, h0, dh)),
                    ("direct", lambda: rg._launch_backward(a, h, h0, dh, route="direct"))):
        ms = graph_ms(torch, lambda: rg._launch_backward(a, h, h0, dh, route=r), reps=20)
        t[r] = {"kernel_ms": ms, "call_ms": call_ms(torch, call, reps=50),
                "share_of_bound": t["bound_ms"] / ms}
    t["plain_ms"] = graph_ms(torch, lambda: rg.rglru_scan_backward_plain(a, h, h0, dh),
                             reps=1, rounds=2)
    t["library_ms"] = None
    import importlib.util
    if importlib.util.find_spec("torch._higher_order_ops.associative_scan"):
        from torch._higher_order_ops.associative_scan import associative_scan

        def combine(x, y):
            return x[0] * y[0], y[0] * x[1] + y[1]

        def library():
            # g_t = dh_t + a_{t+1} g_{t+1}: the forward recurrence, reversed
            a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
            gg = associative_scan(combine, (a_next.flip(1), dh.flip(1)), dim=1,
                                  combine_mode="generic")[1].flip(1)
            h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
            return gg * h_prev, gg, a[:, 0] * gg[:, 0]

        for x, y in zip(library(), rg._launch_backward(a, h, h0, dh)):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)
        t["library_ms"] = call_ms(torch, library, reps=3)
    lib = "n/a" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
    log(f"    {TRAIN_SHAPE} fp32: TMA backward kernel {t['tma']['kernel_ms'] * 1e3:.2f} us "
        f"({t['tma']['share_of_bound']:.1%} of the bound; wrapper call "
        f"{t['tma']['call_ms'] * 1e3:.2f} us), direct kernel "
        f"{t['direct']['kernel_ms'] * 1e3:.2f} us ({t['direct']['share_of_bound']:.1%}; call "
        f"{t['direct']['call_ms'] * 1e3:.2f} us), plain {t['plain_ms'] * 1e3:.2f} us, "
        f"associative_scan reversed {lib}, bound {t['bound_ms'] * 1e3:.2f} us "
        f"({t['bound_by']})")
    out = {"cases": len(cases), "runs": runs, "max_abs_err": max_err,
           "grad_err": grad_err, **t, "kernel_ms": t["tma"]["kernel_ms"],
           "call_ms": t["tma"]["call_ms"], "direct_ms": t["direct"]["kernel_ms"]}
    detail["rglru_backward_kernel"] = out
    return out


# ---------------------------------------------------------------------------
# phase 51: the sLSTM kernels (the scan and its backward)
# ---------------------------------------------------------------------------

#: phase 51's cases, (label, B, S, d_model, heads, a non-zero initial
#: state): xlstm-350m's prefill shape, which is phase 24's training shape
#: too (``TRAIN_CELLS``); the smoke width of phase 26's tenant
#: (``SCHED_SHAPE``); one decode step from a non-zero state; a ragged one
#: (11 rows: two passes of 8; d 100: groups of 8 features across a head's
#: edge); the widest of the narrow route (d 2048 at hd 256: 256 groups of 8
#: features, more than an H100's 132 SMs, so its instances for two blocks an
#: SM run); then the wide route, cut in length: the xLSTM paper's 760M, 1.3B
#: and 2.7B widths with 4 sLSTM heads (hd 384, 512, 640; 2.7B's 320 groups
#: are more than two blocks an SM hold), a ragged wide one (11 rows; hd 2052,
#: r 135 MB, over L2's share, the backward's heads staged in chunks; d 4104
#: not a multiple of 8 features a block) and a decode step at 1.3B's width
SLSTM_CASES = (("prefill", 8, 2048, 1024, 4, False), ("smoke", 8, 128, 64, 2, False),
               ("decode", 8, 1, 1024, 4, True), ("ragged", 11, 37, 100, 4, True),
               ("wide", 8, 16, 2048, 8, True),
               ("xl760m", 8, 32, 1536, 4, False), ("xl1b3", 8, 32, 2048, 4, True),
               ("xl2b7", 8, 16, 2560, 4, False), ("ragged_wide", 11, 9, 4104, 2, True),
               ("decode_wide", 8, 1, 2048, 4, True))
#: kernel against plain version on the card, max |diff| / max |plain|: the
#: forward's every h and final state, the backward's dxwb, dr and the
#: initial state's gradient; each loosened to twice the plain version's own
#: spread between the card and the CPU where that is larger
SLSTM_FWD_TOL, SLSTM_BWD_TOL = 1e-5, 1e-4
#: the cases whose kernels phase 51 times: xlstm-350m's shape (the kernels'
#: line takes its numbers) and the smoke width, where a step is mostly the
#: exchange between the SMs
SLSTM_TIMED = ("prefill", "smoke")
#: the wide route timed at 1.3B's width, prefill length, with no plain loop
#: (its saved tensors from the kernel's own forward)
SLSTM_WIDE_TIMED = (("xl1b3_prefill", 8, 2048, 2048, 4, False),)
#: the plan query's sweep: every d up to this at these head counts, both
#: ways, on the card's SM count and on these
SLSTM_SWEEP_D, SLSTM_SWEEP_HEADS, SLSTM_SWEEP_SMS = 8192, (1, 2, 4, 8), (114, 132)


def slstm_plan_sweep(sl, nsms, d_max=SLSTM_SWEEP_D, heads=SLSTM_SWEEP_HEADS) -> dict:
    """The kernels' plan (``slstm.slstm_plan``, no launch) for every d up
    to ``d_max`` that each of ``heads`` divides, both ways, on each SM count
    of ``nsms``: the shapes by route and the refusals (none may be)."""
    out = {}
    for nsm in nsms:
        routes, refused, widest = {}, [], {}
        for H in heads:
            for d in range(H, d_max + 1, H):
                for backward in (False, True):
                    plan = sl.slstm_plan(d, H, nsm, backward)
                    if plan["refused"]:
                        refused.append([d, H, backward, plan["refused"]])
                        continue
                    routes[plan["route"]] = routes.get(plan["route"], 0) + 1
                    if plan["route"] == "wide":
                        widest["chunks"] = max(widest.get("chunks", 0), plan["chunks"])
                        widest["smem_bytes"] = max(widest.get("smem_bytes", 0), plan["smem_bytes"])
        check(not refused, f"slstm plan on {nsm} SMs refuses {refused[:5]}")
        out[str(nsm)] = {"routes": routes, "refused": refused, "wide_most": widest}
    return out


def slstm_operands(torch, g, B, S, d, H, nonzero):
    """Seeded sLSTM operands on the CPU: xwb (B, S, 4d) as the model feeds
    it (unit-scale input products, the forget gate's bias 3), r at the
    model's init scale (0.02), and the initial state: zeros and m -1e9
    (``layers.NEG_INF``), or, with ``nonzero``, a state of later steps."""
    hd = d // H
    xwb = torch.randn((B, S, 4 * d), generator=g) * 0.6
    xwb[..., d:2 * d] += 3.0
    r = torch.randn((H, hd, 4 * hd), generator=g) * 0.02
    if nonzero:
        h0 = torch.randn((B, d), generator=g) * 0.3
        c0 = torch.randn((B, d), generator=g)
        n0 = torch.rand((B, d), generator=g) * 3 + 0.5
        m0 = torch.randn((B, d), generator=g)
    else:
        h0, c0, n0 = (torch.zeros((B, d)) for _ in range(3))
        m0 = torch.full((B, d), -1e9)
    return [xwb, r, h0, c0, n0, m0]


def planted_per_head_scan(torch, xwb, r, h0, c0, n0, m0):
    """A planted fault for phase 51's gate: the plain loop with each head's
    4 hd recurrent outputs split into that head's own [i | f | z | o] (the
    per-head gate layout), not the whole row's. Returns every h."""
    from repro_torch.kernels.slstm import slstm_gates

    B, _, d4 = xwb.shape
    H, hd = r.shape[0], r.shape[1]
    state, hs = (h0, c0, n0, m0), []
    for xt in xwb.unbind(1):
        rec = torch.bmm(state[0].reshape(B, H, hd).transpose(0, 1), r)  # (H, B, 4hd)
        rec = rec.reshape(H, B, 4, hd).permute(1, 2, 0, 3).reshape(B, d4)
        state = slstm_gates(xt + rec, *state[1:])
        hs.append(state[0])
    return torch.stack(hs, dim=1)


def slstm_bound(B, S, d, H, backward=False, save=False) -> tuple:
    """The least time (ms) of one scan and what bounds it: the recurrent
    products at the FP32 rate against the bytes each operand moves once
    (forward: xwb, r and the state in, every h and the final state out,
    with ``save`` every step's state and pre-activations too; backward: r,
    the saved pre-activations and states, the incoming gradients in, dxwb
    and the initial state's gradient out)."""
    from repro_torch.kernels.slstm import products

    hd = d // H
    n, r_n = B * S * d, H * hd * 4 * hd
    if backward:
        floats = r_n + 4 * n + 3 * n + 3 * B * d + n + 3 * B * d + 4 * n + 4 * B * d
    else:
        floats = 4 * n + r_n + 4 * B * d + n + (3 * n + 4 * n if save else 3 * B * d)
    return bound(4 * floats, products(B, S, d, hd), FP32_FLOPS)


def slstm_phase(torch, sl, detail, dev="cuda", cases=SLSTM_CASES,
                wide_timed=SLSTM_WIDE_TIMED, sweep_d=SLSTM_SWEEP_D) -> dict:
    """Phase 51: the sLSTM kernels against their plain versions on the
    card, at ``cases``: the forward (``_launch``) at inference (every h and
    the final state) and keeping every step (the states and
    pre-activations too) within ``SLSTM_FWD_TOL`` of max |plain|, the
    backward (``_launch_backward``, on the plain forward's saved tensors,
    a non-zero final-state gradient where the state is) within
    ``SLSTM_BWD_TOL``, each loosened to twice the plain version's own spread
    between the card and the CPU where that is larger, one launch a call, a
    second launch identical bit for bit; grad through ``slstm_scan`` (the
    autograd Function: both kernels and ``dr``'s product) against
    autograd of the plain loop on the card within ``SLSTM_BWD_TOL``; the
    planted per-head gate layout (``planted_per_head_scan``) must fail the
    forward's gate; and at the cases of ``SLSTM_TIMED`` the times: both
    kernels by CUDA-graph replay (and per step of the scan), the wrapper's
    call, the plain loops as called and captured in a CUDA graph, the bound;
    at ``wide_timed`` the kernels alone (no plain loop at that length). The
    first timed case's times are the phase's own. First the plan query
    (``slstm_plan_sweep``) over every d up to ``sweep_d`` on the card's SM
    count and ``SLSTM_SWEEP_SMS``: no width may be refused; each case
    records its route. PyTorch has no sLSTM op."""
    from repro_torch.kernels.slstm import slstm_cell

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count if dev != "cpu" else 132
    t0 = time.perf_counter()
    out = {"cases": {}, "sms": nsm,
           "plan_sweep": slstm_plan_sweep(sl, (nsm,) + tuple(n for n in SLSTM_SWEEP_SMS
                                                             if n != nsm), sweep_d)}
    out["plan_sweep_s"] = time.perf_counter() - t0
    log(f"[51] the plan query over d <= {sweep_d}, H {SLSTM_SWEEP_HEADS}, both ways: "
        + "; ".join(f"{n} SMs {v['routes']}, none refused" for n, v in out["plan_sweep"].items())
        + f" ({out['plan_sweep_s']:.1f} s)")
    g = torch.Generator().manual_seed(51)
    for label, B, S, d, H, nonzero in cases:
        t0 = time.perf_counter()
        what = f"slstm {label} ({B}, {S}, d {d}, H {H})"
        cpu = slstm_operands(torch, g, B, S, d, H, nonzero)
        card = [t.to(dev) for t in cpu]
        rec = {"route": {way: {k: v for k, v in sl.slstm_plan(d, H, nsm, way == "backward").items()
                               if k in ("route", "registers", "blocks_an_sm", "grid",
                                        "groups_a_block", "chunks", "r_jobs_in_shared")}
                         for way in ("forward", "backward")}}
        # the forward, every output, at inference and keeping every step
        want = sl.slstm_scan_plain(*card, True)
        spread = max(rel_err(a.cpu(), b)
                     for a, b in zip(want, sl.slstm_scan_plain(*cpu, True)))
        tol_f = max(SLSTM_FWD_TOL, 2 * spread)
        final = [want[0], want[1][:, -1:], want[2][:, -1:], want[3][:, -1:], want[4][:, :0]]
        errs, abs_err = {}, 0.0
        for save, ref in ((False, final), (True, want)):
            before = sl.slstm_scan.launches
            got = sl._launch(*card, save)
            again = sl._launch(*card, save)
            check(sl.slstm_scan.launches == before + 2, f"{what}: forward launches")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: a second forward launch (save={save}) differs")
            for name, a, b in zip(("hs", "cs", "ns", "ms", "pre"), got, ref):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{what} {name}: {tuple(a.shape)} {a.dtype}, want {tuple(b.shape)}")
                if b.numel():
                    errs[f"{name}{'' if save else '_final'}"] = rel_err(a, b)
                    abs_err = max(abs_err, float((a - b).abs().max()))
        worst = max(errs.values())
        check(worst <= tol_f, f"{what}: forward kernel vs plain {errs} > {tol_f:.3g}")
        rec["forward"] = {"rel_err": errs, "worst": worst, "tol": tol_f,
                          "plain_card_vs_cpu": spread, "max_abs_err": abs_err}
        planted = rel_err(planted_per_head_scan(torch, *card), want[0])
        check(planted > tol_f, f"{what}: the planted per-head gate layout moves every h "
              f"by {planted:.3e}, inside the gate {tol_f:.3g}")
        rec["planted_per_head_rel_err"] = planted
        # the backward on the plain forward's saved tensors
        gg = torch.Generator().manual_seed(B * S + d)
        dhs = torch.randn((B, S, d), generator=gg)
        d_final = [torch.randn((B, d), generator=gg) * float(nonzero) for _ in range(3)]
        _, cs, ns, ms, pre = want
        args = (card[1], pre, cs, ns, ms, *card[3:], dhs.to(dev), *(t.to(dev) for t in d_final))
        bwant = sl.slstm_scan_backward_plain(*args)
        cpu_args = [t.cpu() for t in args]
        spread_b = max(rel_err(a.cpu(), b)
                       for a, b in zip(bwant, sl.slstm_scan_backward_plain(*cpu_args)))
        tol_b = max(SLSTM_BWD_TOL, 2 * spread_b)
        before = sl.slstm_scan_backward.launches
        bgot = sl._launch_backward(*args)
        bagain = sl._launch_backward(*args)
        check(sl.slstm_scan_backward.launches == before + 2, f"{what}: backward launches")
        check(all(torch.equal(a, b) for a, b in zip(bgot, bagain)),
              f"{what}: a second backward launch differs")
        berrs = {name: rel_err(a, b) for name, a, b in
                 zip(("dxwb", "dh0", "dc0", "dn0", "dm0"), bgot, bwant)}
        babs = max(float((a - b).abs().max()) for a, b in zip(bgot, bwant))
        check(max(berrs.values()) <= tol_b,
              f"{what}: backward kernel vs plain {berrs} > {tol_b:.3g}")
        # grad through the op against autograd of the plain loop, dr included
        grads = []
        for run in ("op", "loop"):
            xs = [t.clone().requires_grad_() for t in card]
            if run == "op":
                hs, _, cT, nT, mT = sl.slstm_scan(*xs)
            else:
                state, steps = tuple(xs[2:]), []
                for xt in xs[0].unbind(1):
                    state = slstm_cell(xt, xs[1], state)
                    steps.append(state[0])
                hs, (_, cT, nT, mT) = torch.stack(steps, dim=1), state
            loss = (hs * args[8]).sum() + sum((s * t).sum() for s, t in
                                              zip((cT, nT, mT), args[9:]))
            grads.append(torch.autograd.grad(loss, xs))
        gerrs = {name: rel_err(a, b) for name, a, b in
                 zip(("dxwb", "dr", "dh0", "dc0", "dn0", "dm0"), *grads)}
        check(max(gerrs.values()) <= tol_b,
              f"{what}: grad through slstm_scan vs autograd of the plain loop {gerrs} "
              f"> {tol_b:.3g}")
        rec["backward"] = {"rel_err": berrs, "worst": max(berrs.values()), "tol": tol_b,
                           "plain_card_vs_cpu": spread_b, "max_abs_err": babs,
                           "grad_rel_err": gerrs}
        rec["seconds"] = time.perf_counter() - t0
        out["cases"][label] = rec
        log(f"[51] {what}, {rec['route']['forward']['route']} route: forward kernel vs "
            f"plain worst {worst:.3e} (gate {tol_f:.3g}; "
            f"the plain version card vs CPU {spread:.3e}), the planted per-head gate layout "
            f"{planted:.3e} (fails the gate); backward {max(berrs.values()):.3e} (gate "
            f"{tol_b:.3g}; plain card vs CPU {spread_b:.3e}); grad through the op vs "
            f"autograd of the loop {max(gerrs.values()):.3e} (dr {gerrs['dr']:.3e}); "
            f"second launches identical ({rec['seconds']:.1f} s)")
        del card, cpu, want, args, cpu_args, bwant, bgot, bagain, grads
    # the times, at the timed cases (and the wide route's, kernels alone)
    out["times"] = {}
    for label, B, S, d, H, nonzero in (*(c for c in cases if c[0] in SLSTM_TIMED), *wide_timed):
        t0 = time.perf_counter()
        card = [t.to(dev) for t in slstm_operands(torch, g, B, S, d, H, nonzero)]
        with_plain = label in SLSTM_TIMED
        hs, cs, ns, ms, pre = (sl.slstm_scan_plain(*card, True) if with_plain
                               else sl._launch(*card, True))
        dhs = torch.randn((B, S, d), generator=g).to(dev)
        zeros = [torch.zeros_like(card[2]) for _ in range(3)]
        args = (card[1], pre, cs, ns, ms, *card[3:], dhs, *zeros)
        reps = 3 if S > 256 else 20
        t = {"shape": [B, S, d, H], "route": sl.slstm_plan(d, H, nsm)["route"]}
        for name, kernel, call, plain, backward, save in (
                ("forward", lambda: sl._launch(*card, False), lambda: sl.slstm_scan(*card),
                 lambda: sl.slstm_scan_plain(*card, False), False, False),
                ("forward_saving", lambda: sl._launch(*card, True), None, None, False, True),
                ("backward", lambda: sl._launch_backward(*args),
                 lambda: sl.slstm_scan_backward(*args),
                 lambda: sl.slstm_scan_backward_plain(*args), True, False)):
            plain = plain if with_plain else None
            bound_ms, bound_by = slstm_bound(B, S, d, H, backward, save)
            ms_k = graph_ms(torch, kernel, reps=reps, rounds=3)
            t[name] = {"kernel_ms": ms_k, "us_per_step": 1e3 * ms_k / S, "bound_ms": bound_ms,
                       "bound_by": bound_by, "share_of_bound": bound_ms / ms_k,
                       "call_ms": call_ms(torch, call, reps=reps) if call else None,
                       # captured first: its warm-up calls warm the call timed next
                       "plain_graph_ms": (graph_ms(torch, plain, reps=1, rounds=2)
                                          if plain else None),
                       "plain_ms": once_ms(torch, plain) if plain else None}
        log(f"    {label} ({B}, {S}, d {d}, H {H}, {t['route']} route): " + "; ".join(
            f"{k} kernel {v['kernel_ms']:.3f} ms, {v['us_per_step']:.3f} us a step "
            f"({v['share_of_bound']:.1%} of the bound {v['bound_ms']:.3f} ms, {v['bound_by']}"
            + (f"; wrapper call {v['call_ms']:.3f} ms" if v["call_ms"] else "") + ")"
            + (f", plain loop {v['plain_ms']:.1f} ms, in a CUDA graph "
               f"{v['plain_graph_ms']:.1f} ms" if v["plain_ms"] else "")
            for k, v in t.items() if k not in ("shape", "route"))
            + f"; PyTorch has no sLSTM op ({time.perf_counter() - t0:.1f} s)")
        t["seconds"] = time.perf_counter() - t0
        out["times"][label] = t
        del card, args, hs, cs, ns, ms, pre
    cases_out, first = out["cases"].values(), next(iter(out["times"].values()))
    out.update(first)
    out.update({
        "max_abs_err": max(c["forward"]["max_abs_err"] for c in cases_out),
        "backward_max_abs_err": max(c["backward"]["max_abs_err"] for c in cases_out),
        "kernel_ms": first["forward"]["kernel_ms"], "plain_ms": first["forward"]["plain_ms"],
        "bound_ms": first["forward"]["bound_ms"], "bound_by": first["forward"]["bound_by"],
        "library_ms": None})
    detail["slstm_kernel"] = out
    return out


def train_phase(torch, rg, detail, phase=16, arch=ARCH, dev="cuda", cfg=None,
                steps=3) -> dict:
    """Phases 16, 20, 24, 32 and 36: train ``arch`` at full width through
    ``repro_torch.runtime.Trainer`` (the trainer of ``launch.train``) on its
    ``TRAIN_CELLS`` batch, ``steps`` AdamW steps of the seeded pipeline's batches
    (Zipf tokens; embeddings, or frames and tokens); returns the
    launches and times. Each step launches the RG-LRU and sLSTM forward
    kernels once a layer and once more a unit layer that ``remat="full"``
    recomputes, and their backward kernels once a layer, the RG-LRU's all on
    the TMA kernels (``step_launches``); no other kernel wrapper may launch
    (qwen2-1.5b and gemma3-4b launch none). The second run's trainer, warm,
    is the one profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.models import costs
    from repro_torch.models.config import ShapeCell
    from repro_torch.runtime import Trainer, TrainerConfig

    _tf32_off(torch)
    full = cfg is None
    cfg = get_config(arch) if full else cfg
    B, S = TRAIN_CELLS[arch]
    ws = wrappers()
    want = _want(ws, **step_launches(cfg))
    want_fwd, n_rglru = want["rglru_scan"], want["rglru_scan_backward"]
    check(not full or arch != ARCH or (want_fwd, n_rglru) == (34, 18),
          f"{want_fwd} forward and {n_rglru} backward launches a step at full width")
    tcfg = TrainerConfig(seq_len=S, global_batch=B, total_steps=steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _zero_launches(ws)
    rg.rglru_scan.launches_tma = rg.rglru_scan_backward.launches_tma = 0
    per_step, walls = [], []

    def timed_step(tr) -> float:
        before = _launches(ws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = tr.run(1)["losses"][0]
        walls.append(time.perf_counter() - t1)
        per_step.append({k: n - before[k] for k, n in _launches(ws).items()})
        return loss

    losses = [timed_step(trainer) for _ in range(steps)]
    check(trainer.state.step == steps, f"{arch}: step {trainer.state.step}")
    launches = (rg.rglru_scan.launches, rg.rglru_scan_backward.launches)
    launches_tma = (rg.rglru_scan.launches_tma, rg.rglru_scan_backward.launches_tma)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    del trainer
    torch.cuda.empty_cache()
    again = Trainer(cfg, tcfg, device=dev)
    first = again.run(1)["losses"][0]
    check(first == losses[0], f"{arch}: a second run's first loss {first!r} differs "
          f"from {losses[0]!r}")
    check(launches_tma == launches, f"RG-LRU launches (forward, backward) {launches}, "
          f"of which {launches_tma} took the TMA route: want all")
    check(all(p == want for p in per_step),
          f"{arch}: kernel launches per step {per_step}, want "
          f"{ {k: n for k, n in want.items() if n} } and no other")
    check(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    kernels = device_kernels(torch, lambda: again.run(1))
    del again
    torch.cuda.empty_cache()
    step_s = sum(walls[1:]) / len(walls[1:])
    busy_ms = sum(k["device_ms"] for k in kernels)
    fwd_ms = sum(k["device_ms"] for k in kernels if "rglru_scan_tma_kernel" in k["op"])
    bwd_ms = sum(k["device_ms"] for k in kernels
                 if "rglru_scan_backward_tma_kernel" in k["op"])
    slstm_ms = [sum(k["device_ms"] for k in kernels if f"slstm_{way}_kernel" in k["op"])
                for way in ("forward", "backward")]
    flops = costs.model_flops(cfg, ShapeCell(f"train_{B}x{S}", "train", S, B))
    real_flops = 6.0 * n_params * B * S
    out = {"batch": B, "seq_len": S, "microbatches": cfg.microbatches, "steps": steps,
           "init_s": init_s, "step_s": walls, "losses": losses, "steady_step_s": step_s,
           "tokens_per_s": B * S / step_s, "launches": list(launches),
           "launches_tma": list(launches_tma),
           "launches_per_step": [(p["rglru_scan"], p["rglru_scan_backward"])
                                 for p in per_step],
           "slstm_launches_per_step": [(p["slstm_scan"], p["slstm_scan_backward"])
                                       for p in per_step],
           "peak_memory_gb": peak_gb, "params": cfg.param_count(),
           "model_flops_per_step": flops, "model_tflop_s": flops / step_s / 1e12,
           "bf16_tc_share": flops / step_s / BF16_TC_FLOPS,
           "numel": n_params, "numel_flops_per_step": real_flops,
           "numel_bf16_tc_share": real_flops / step_s / BF16_TC_FLOPS,
           "second_run_first_loss": first,
           "profiled_step": {"layers": cfg.n_layers, "untraced_s": step_s,
                             "device_busy_ms": busy_ms,
                             "idle_share": 1.0 - busy_ms / 1e3 / step_s,
                             "rglru_forward_ms": fwd_ms, "rglru_backward_ms": bwd_ms,
                             "slstm_forward_ms": slstm_ms[0],
                             "slstm_backward_ms": slstm_ms[1],
                             "top_kernels": kernels[:15]}}
    detail[f"train_{run_key(arch, cfg)}"] = out
    mb = cfg.microbatches
    log(f"[{phase}] {cfg.name} ({cfg.n_layers} layers, {cfg.attention_impl} attention) "
        f"training at full width, {B} x {S} tokens a step "
        f"({mb} microbatch{'es' if mb > 1 else ''}), AdamW (init {init_s:.2f} s): steps "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, {out['tokens_per_s']:.0f} tokens/s "
        f"(steps 2-{steps}); model FLOPs "
        f"{flops / 1e12:.1f} T a step, "
        f"{out['model_tflop_s']:.1f} TFLOP/s, {out['bf16_tc_share']:.2%} of the bf16 "
        f"tensor-core peak; losses {', '.join(f'{x:.5f}' for x in losses)}; kernel "
        f"launches a step: RG-LRU {want_fwd} forward + {n_rglru} backward, all on the TMA "
        f"kernels, sLSTM {want['slstm_scan']} forward + {want['slstm_scan_backward']} "
        f"backward, no other; peak {peak_gb:.2f} GB; a second run's first loss identical")
    ps = out["profiled_step"]
    log(f"    one profiled step: kernels busy {busy_ms:.1f} ms (device idle "
        f"{ps['idle_share']:.1%} of an untraced step, {ps['untraced_s']:.3f} s); RG-LRU "
        f"forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms; sLSTM forward "
        f"{slstm_ms[0]:.2f} ms, backward {slstm_ms[1]:.2f} ms; top: " + "; ".join(
            f"{k['op'][:48]} {k['device_ms']:.1f} ms x{k['count']}" for k in kernels[:5]))
    log(f"    model FLOPs by 6 x numel ({n_params / 1e6:.1f}M, not param_count's "
        f"{cfg.param_count() / 1e6:.1f}M): {real_flops / 1e12:.1f} T a step, "
        f"{out['numel_bf16_tc_share']:.2%} of the bf16 tensor-core peak")
    return out


def train_devices_phase(torch, rg, detail, phase=17, arch=ARCH, n_layers=5, S=256,
                        dev="cuda", cfg=None, behind=None) -> None:
    """Phases 17, 21, 25, 33 and 37: one float32 training step of ``arch`` on
    the card against the CPU at full width and cut depth, B 1, ``S`` tokens
    (or embeddings; an encoder model's ``S`` frames beside them), the same
    weights: the loss, every gradient leaf (QKV biases, an untied ``head``
    and an encoder's leaves included), the kernel launches (the
    blocked path trains on its twin: no flash launch), then one AdamW
    update on the card's gradients, on the card and on the CPU. With
    ``behind`` (a :class:`Behind`) the CPU half (the CPU's step, the
    comparisons, the CPU's update) runs on its thread beside the phases
    that follow, and its checks fail at its drain."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import wrappers
    from repro_torch.models import init_params, loss_fn, param_leaves
    from repro_torch.optim import make_optimizer

    cfg = cfg or get_config(arch, n_layers=n_layers, dtype="float32")
    B = 1
    ws = wrappers()
    t0 = time.perf_counter()
    card_model = init_params(cfg, torch.Generator(device=dev).manual_seed(phase),
                             trainable=True)
    cpu_model = copy.deepcopy(card_model).cpu()
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, S, B, seed=phase).items()}
    _zero_launches(ws)
    card_loss = loss_fn(card_model, {k: v.to(dev) for k, v in batch.items()})
    card_loss.backward()
    card_launches = _launches(ws)
    card_loss = card_loss.detach()
    card_leaves, cpu_leaves = param_leaves(card_model), param_leaves(cpu_model)
    want = _want(ws, **step_launches(cfg))
    launches = (want["rglru_scan"], want["rglru_scan_backward"])
    check(card_launches == want,
          f"{arch}: kernel launches {card_launches}, want "
          f"{ {k: n for k, n in want.items() if n} } and no other")
    biases = [k for k in cpu_leaves if k.rsplit("/", 1)[-1] in ("bq", "bk", "bv")]
    check(bool(biases) == cfg.qkv_bias, f"{arch}: bias leaves {biases}")
    check(("head" in cpu_leaves) != cfg.tie_embeddings, f"{arch}: leaves {list(cpu_leaves)}")
    encoder = [k for k in cpu_leaves if k.startswith("encoder")]
    check(bool(encoder) == bool(cfg.encoder_layers), f"{arch}: encoder leaves {encoder}")
    # one AdamW update on the card's gradients, on the card now and on the
    # CPU in the CPU half (the update leaves the gradients as they are); the
    # card's gradients and updated weights go to the host, and the CPU half
    # touches no card memory
    opt = make_optimizer("adamw", peak_lr=3e-4, warmup=0, total=100)
    grads = {k: [p.grad.cpu() for p in ps] for k, ps in card_leaves.items()}
    opt.update({k: [p.grad for p in ps] for k, ps in card_leaves.items()},
               opt.init(card_leaves), card_leaves, 0)
    after = {k: [p.detach().cpu() for p in ps] for k, ps in card_leaves.items()}
    card_loss = float(card_loss)
    del card_model, card_leaves
    card_s = time.perf_counter() - t0

    def cpu_half():
        t1 = time.perf_counter()
        cpu_loss = loss_fn(cpu_model, batch)
        cpu_loss.backward()
        cpu_loss = cpu_loss.detach()
        loss_err = abs(card_loss - float(cpu_loss)) / abs(float(cpu_loss))
        check(math.isfinite(card_loss) and loss_err <= TRAIN_LOSS_REL,
              f"{arch}: card loss {card_loss!r} vs CPU {float(cpu_loss)!r}: "
              f"{loss_err:.3e}")
        grad_err, worst = 0.0, ""
        for path, ps in cpu_leaves.items():
            for p, g in zip(ps, grads[path]):
                e = float((g - p.grad).abs().max() / p.grad.abs().max())
                if e > grad_err:
                    grad_err, worst = e, path
        check(grad_err <= TRAIN_GRAD_SHARE, f"{arch}: card vs CPU gradient of {worst}: "
              f"{grad_err:.3e} of its max |g| > {TRAIN_GRAD_SHARE:g}")
        opt.update(grads, opt.init(cpu_leaves), cpu_leaves, 0)
        opt_err = 0.0
        for path, ps in cpu_leaves.items():
            for p, q in zip(ps, after[path]):
                opt_err = max(opt_err, float((q - p.detach()).abs().max()
                                             / p.detach().abs().max()))
        check(opt_err <= OPT_CARD_CPU, f"{arch}: AdamW on the card vs the CPU, same "
              f"gradients: {opt_err:.3e} of max |p| > {OPT_CARD_CPU:g}")
        seconds = card_s + time.perf_counter() - t1
        detail[f"train_card_vs_cpu_{run_key(arch, cfg)}"] = {
            "loss_card": card_loss, "loss_cpu": float(cpu_loss),
            "loss_rel_err": loss_err, "grad_err": grad_err, "worst_grad_leaf": worst,
            "leaves": len(cpu_leaves), "bias_leaves": biases, "head": "head" in cpu_leaves,
            "launches": list(launches), "encoder_leaves": len(encoder),
            "slstm_launches": [want["slstm_scan"], want["slstm_scan_backward"]],
            "adamw_err": opt_err, "seconds": seconds,
            "cpu_half_beside_later_phases": behind is not None}
        log(f"[{phase}] {cfg.name} n_layers={cfg.n_layers} ({cfg.attention_impl} attention) "
            f"float32, {B} x {S}, one step: card "
            f"vs CPU loss {loss_err:.3e} (<= {TRAIN_LOSS_REL:g}), gradients {grad_err:.3e} of "
            f"each leaf's max |g| over {len(cpu_leaves)} leaves, {len(biases)} of them QKV "
            f"biases, {len(encoder)} the encoder's (<= {TRAIN_GRAD_SHARE:g}; worst {worst}); "
            f"AdamW on the card's gradients, "
            f"card vs CPU {opt_err:.3e} of max |p| (<= {OPT_CARD_CPU:g}); RG-LRU launches "
            f"{launches[0]} forward + {launches[1]} backward, sLSTM "
            f"{want['slstm_scan']} + {want['slstm_scan_backward']}, no other kernel "
            f"({seconds:.1f} s" + ("; its CPU half beside the next phase)"
                                   if behind is not None else ")"))

    if behind is None:
        cpu_half()
    else:
        behind.submit(cpu_half)


def blocked_phases(torch, rg, detail, rg_t, dev="cuda", behind=None) -> dict:
    """Phases 30-33: serve (30) and train (32) yi-9b, phi4-mini-3.8b and
    phi-3-vision-4.2b at full width, and yi-9b and gemma3-4b on the blocked
    attention path, each also on the card against the CPU at cut depth (31,
    33). The two training steps of 33 go first, each one's CPU half on
    ``behind`` (a :class:`Behind`; one of its own if none is given) beside
    30's serving or 32's training. Returns the flash launches of the
    blocked prefills (phase 30's main runs), all and on the tensor-core
    kernel, and this process's seconds of each phase."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    def p30():
        # 30: the default xla path launches no kernel; the blocked path one flash
        # launch per attention layer a prefill, on the same weights (seed 0)
        logits = {}
        for arch in ARCHS_30:
            serve_phase(torch, rg, detail, rg_t, 30, arch, dev=dev,
                        logits_out=logits.setdefault(arch, {}))
        flash, flash_tc = {}, {}
        for arch in ("yi-9b", "gemma3-4b"):
            serve_phase(torch, rg, detail, rg_t, 30, arch, dev=dev,
                        cfg=get_config(arch, attention_impl="blocked"),
                        logits_out=logits.setdefault(f"{arch}_blocked", {}))
            run = detail[f"serve_{arch}_blocked"]
            flash[arch], flash_tc[arch] = (run["kernel_launches"]["flash_attention"],
                                           run["flash_launches_tc"])
        xla, blk = logits["yi-9b"], logits["yi-9b_blocked"]
        err = rel_err(blk["prefill"], xla["prefill"])
        err_all = rel_err(blk["hidden"], xla["hidden"])
        check(err <= CARD_CPU_BF16, f"yi-9b blocked vs xla prefill logits {err:.3e} > "
              f"{CARD_CPU_BF16:g} of max |logits|")
        check(err_all <= CARD_CPU_BF16, f"yi-9b blocked vs xla prefill hidden state at every "
              f"position {err_all:.3e} > {CARD_CPU_BF16:g} of its max")
        del logits, xla, blk
        pre = {k: min(detail[f"serve_{k}"]["prefill_s"]) for k in ("yi-9b", "yi-9b_blocked")}
        detail["serve_yi-9b_blocked"]["vs_xla"] = {
            "rel_err": err, "rel_err_all_positions": err_all, "prefill_s": pre}
        # the window each gemma3-4b layer hands the blocked path (phase 31 holds
        # the kernel's windowed result to the twin's past 1024 positions)
        model = Model(get_config("gemma3-4b", attention_impl="blocked"), device="meta")
        windows = [layer.mixer.window for layer in model.layers]
        check(windows == [model.cfg.window if k == "sliding" else None for k in model.kinds],
              f"gemma3-4b windows {windows}")
        log(f"    yi-9b prefill, xla {pre['yi-9b']:.3f} s vs blocked {pre['yi-9b_blocked']:.3f} s "
            f"({pre['yi-9b'] / pre['yi-9b_blocked']:.2f}x, this call); blocked logits within "
            f"{err:.3e} of the xla run's max |logits|, the hidden state at every position "
            f"within {err_all:.3e} of its max; gemma3-4b's flash launches: "
            f"{windows.count(model.cfg.window)} with window {model.cfg.window}, "
            f"{windows.count(None)} full")
        del model
        return flash, flash_tc

    def p31():
        # 31: card against CPU; the card's blocked path runs the kernel, the CPU's its
        # twin. On the blocked cases the every-position check must catch a planted
        # non-causal kernel call, and gemma3-4b's dropped window in float32 (in
        # bf16 it changes the hidden state less than rounding does; phase 13
        # holds the tensor-core kernel's window at gemma3-4b's shape)
        both = ("float32", "bfloat16")
        planted = {"yi-9b": (("noncausal", planted_noncausal, both),),
                   "gemma3-4b": (("noncausal", planted_noncausal, both),
                                 ("no_window", planted_no_window, ("float32",)))}
        for arch, n_layers, S, over in CUT_30:
            devices_phase(torch, rg, detail, 31, arch, n_layers, S, dev=dev,
                          cfg_of=lambda dt, a=arch, n=n_layers, o=over: get_config(
                              a, n_layers=n, dtype=dt, **o),
                          controls=planted[arch] if over.get("attention_impl") == "blocked"
                          else ())

    def p32():
        # 32: training; the blocked path trains on its twin, so no kernel launches
        for arch, n_layers, over in TRAIN_30:
            cfg = get_config(arch, logits_chunk=512, **over)
            if n_layers:
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            train_phase(torch, rg, detail, 32, arch, dev=dev, cfg=cfg)
        steps = {k: detail[f"train_{k}"]["steady_step_s"] for k in ("yi-9b", "yi-9b_blocked")}
        log(f"    yi-9b (12 layers) step, xla {steps['yi-9b']:.3f} s vs blocked twin "
            f"{steps['yi-9b_blocked']:.3f} s ({steps['yi-9b_blocked'] / steps['yi-9b']:.2f}x)")

    def p33(i):
        # 33: one float32 step, card against CPU
        arch, n_layers, S, over = TRAIN_CUT_30[i]
        train_devices_phase(torch, rg, detail, 33, arch, n_layers, S, dev=dev,
                            cfg=get_config(arch, n_layers=n_layers, dtype="float32", **over),
                            behind=behind)

    phase_s = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = phase_s.get(phase, 0.0) + time.perf_counter() - t0
        return out

    behind = behind or Behind(torch)
    timed(31, p31)
    timed(33, p33, 0)
    flash, flash_tc = timed(30, p30)
    timed(33, p33, 1)
    timed(32, p32)
    timed(33, behind.drain)
    detail["phases_30_33_s"] = phase_s
    log("    phases 30-33 took "
        + ", ".join(f"{p}: {v:.1f} s" for p, v in sorted(phase_s.items())))
    return {"flash": flash, "flash_tc": flash_tc, "phase_s": phase_s}


def whisper_phases(torch, rg, detail, rg_t, dev="cuda") -> dict:
    """Phases 34-37: serve (34) and train (36) whisper-tiny at full width
    and depth, and hold each to the CPU (35, 37). Its attention is the
    grouped einsum everywhere (the encoder is non-causal, cross-attention
    has a memory, and its config asks for ``xla``), so no kernel wrapper
    may launch in any of them. Returns every wrapper's launches summed
    over the runs the four phases count (each phase zeroes the counts
    before its checked run; all 0) and the seconds of each phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers

    ws = wrappers()
    counted = dict.fromkeys(ws, 0)
    phase_s, t0 = {}, time.perf_counter()

    def tally():
        for k, n in _launches(ws).items():
            counted[k] += n
        _zero_launches(ws)

    _zero_launches(ws)
    serve_phase(torch, rg, detail, rg_t, 34, WHISPER, dev=dev, shape=WHISPER_SERVE)
    tally()
    phase_s[34] = time.perf_counter() - t0
    T, S = WHISPER_CUT
    devices_phase(torch, rg, detail, 35, WHISPER, S=S, dev=dev,
                  cfg_of=lambda dt: get_config(WHISPER, dtype=dt), T=T)
    tally()
    phase_s[35] = time.perf_counter() - t0 - sum(phase_s.values())
    train_phase(torch, rg, detail, 36, WHISPER, dev=dev)
    tally()
    phase_s[36] = time.perf_counter() - t0 - sum(phase_s.values())
    train_devices_phase(torch, rg, detail, 37, WHISPER, S=S, dev=dev,
                        cfg=get_config(WHISPER, dtype="float32"))
    tally()
    phase_s[37] = time.perf_counter() - t0 - sum(phase_s.values())
    check(not any(counted.values()), f"whisper-tiny's phases launched {counted}")
    detail["phases_34_37_s"] = phase_s
    detail["whisper_launches"] = counted
    log("    phases 34-37 took " + ", ".join(f"{p}: {v:.1f} s" for p, v in phase_s.items())
        + "; no kernel wrapper launched (" + ", ".join(f"{k} {n}" for k, n in counted.items())
        + ")")
    return {"launches": counted, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phases 38-41: the MoE models
# ---------------------------------------------------------------------------


def moe_serve_extras(torch, model, prompts, cache_len: int, xla=None) -> dict:
    """Phases 38 and 40, on the served model before it is freed: one more
    prefill of the prompts with its routing tapped (the share of (token,
    slot) assignments the capacity drops, the tokens tied exactly at the
    top-k boundary, per MoE layer); with ``xla`` (the xla run's
    ``logits_out``) two prefills on ``attention_impl="blocked"`` on the same
    weights, each one flash launch per attention layer, all on the
    tensor-core kernel, and no other launch: the first as the model runs,
    timed; the second with each MoE layer routed as in the xla prefill
    (``forced_routes``), its logits and hidden state at every position
    within ``CARD_CPU_BF16`` of the xla run's. The xla path rounds the
    attention scores to bf16 (as the JAX einsum does) and the flash kernel
    keeps them in float32, so the MoE inputs of the two paths differ by
    more than the router's rounding, and a near-tie routed one way moves a
    row by O(1) and, a layer later, every row that attends to it: routed
    alike, the comparison holds the attention path at every position. The
    blocked run's own routing against the xla run's (``route_check`` on
    each layer's continuous input) is recorded: pairs on another expert,
    those beyond 2 bf16 ulps, rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wrappers
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import prefill

    batch = prompt_batch(model, prompts)
    with tapped_routes(model) as calls:
        prefill(model, batch, cache_len)
    n = sum(c["kept"].numel() for c in calls)
    out = {"cap": calls[0]["cap"], "assignments": n,
           "dropped": sum(int((~c["kept"]).sum()) for c in calls),
           "ties": sum(c["ties"] for c in calls),
           "by_layer": [{"dropped": int((~c["kept"]).sum()), "ties": c["ties"]}
                        for c in calls]}
    out["dropped_share"] = out["dropped"] / n
    log(f"    routing of the {prompts.shape[0]} x {prompts.shape[1]} prefill: capacity "
        f"{out['cap']} a row, {out['dropped']} of {n} (token, slot) assignments dropped "
        f"({out['dropped_share']:.3%}), {out['ties']} tokens tied exactly at the top-k "
        f"boundary over {len(calls)} MoE layers")
    if xla is None:
        return out
    ws = wrappers()
    n_attn = sum(kind in ("full", "sliding") for kind in model.kinds)
    check(_launches(ws) == _want(ws), f"{model.cfg.name} xla prefills launched "
          f"{_launches(ws)}; want no launch")

    def blocked_prefill(routes=None, tap=False, twin=False):
        got = {}
        with attention_impl(model, "blocked"), contextlib.ExitStack() as stack:
            if twin:
                stack.enter_context(twin_attention())
            if routes is not None:
                stack.enter_context(forced_routes(model, routes))
            if tap:
                got["calls"] = stack.enter_context(tapped_routes(model))
                stack.enter_context(prefill_hidden(model, got, "hidden"))
            torch.cuda.synchronize()
            _zero_launches(ws)
            fa.flash_attention.launches_tc = 0
            t0 = time.perf_counter()
            _, got["logits"] = prefill(model, batch, cache_len)
            torch.cuda.synchronize()
            got["s"] = time.perf_counter() - t0
        got["launched"], got["tc"] = _launches(ws), fa.flash_attention.launches_tc
        n = 0 if twin else n_attn
        check(got["launched"] == _want(ws, flash_attention=n) and got["tc"] == n,
              f"{model.cfg.name} blocked prefill ({'twin' if twin else 'flash'}) launched "
              f"{got['launched']} ({got['tc']} on the tensor-core flash kernel); want {n} "
              f"flash launches, all tensor-core, and no other")
        check(bool(torch.isfinite(got["logits"]).all()), "blocked prefill logits not finite")
        return got

    first = blocked_prefill()
    got = blocked_prefill(routes=calls, tap=True)
    flips = route_check(calls, got["calls"], "bfloat16")
    flips["rows_of"] = flips.pop("rows").numel()
    err = rel_err(got["logits"].float().cpu(), xla["prefill"])
    err_all = rel_err(got["hidden"], xla["hidden"])
    check(err <= CARD_CPU_BF16,
          f"blocked vs xla prefill logits {err:.3e} > {CARD_CPU_BF16:g}")
    check(err_all <= CARD_CPU_BF16, f"blocked vs xla prefill hidden state at every "
          f"position {err_all:.3e} > {CARD_CPU_BF16:g}")
    # flash against the twin blocked_attention_plain (the JAX
    # _blocked_attention step for step) on the card, both with float32
    # scores: flash on its own routes, then the twin taking them. Flash
    # multiplies bf16 probabilities into V, the twin float32 ones, so the
    # MoE inputs differ by more than the router's rounding: the twin's own
    # flips are recorded, not gated
    own = blocked_prefill(tap=True)
    twin = blocked_prefill(routes=own["calls"], tap=True, twin=True)
    twin_flips = route_check(own["calls"], twin["calls"], "bfloat16")
    twin_flips["rows_of"] = twin_flips.pop("rows").numel()
    twin_err = rel_err(twin["hidden"], own["hidden"])
    check(twin_err <= CARD_CPU_BF16, f"the twin vs flash on the card, blocked prefill: "
          f"hidden state at every position {twin_err:.3e} > {CARD_CPU_BF16:g}")
    runs = (first, got, own)
    out["blocked"] = {"flash": first["launched"]["flash_attention"], "flash_tc": first["tc"],
                      "launches": [r["launched"] for r in runs],
                      "twin_launches": twin["launched"],
                      "prefill_s": first["s"], "twin_prefill_s": twin["s"], "rel_err": err,
                      "rel_err_all_positions": err_all, "routing": flips,
                      "twin_rel_err_all_positions": twin_err, "twin_routing": twin_flips}
    log(f"    blocked prefills on the same weights: {first['s']:.3f} s, "
        f"{out['blocked']['flash']} flash launches each ({out['blocked']['flash_tc']} "
        f"tensor-core) and no other; routed as the xla run, logits within "
        f"{err:.3e}, hidden state at every position within {err_all:.3e} of the xla "
        f"run's max; its own routing: {flips['tokens']} token-layers on another set of "
        f"experts ({flips['unjustified']} beyond 2 bf16 ulps of the xla logits), "
        f"{flips['reordered']} reordered, {flips['n_rows']} of {flips['rows_of']} rows")
    log(f"    the twin blocked_attention_plain on the card ({twin['s']:.3f} s, no launch) "
        f"taking flash's routes: hidden state at every position within {twin_err:.3e} of "
        f"flash's max (<= {CARD_CPU_BF16:g}); its own routing against flash's: "
        f"{twin_flips['tokens']} token-layers on another set of experts "
        f"({twin_flips['unjustified']} beyond 2 bf16 ulps of flash's logits), "
        f"{twin_flips['reordered']} reordered, {twin_flips['n_rows']} of "
        f"{twin_flips['rows_of']} rows")
    return out


def moe_layer_phase(torch, detail, dev="cuda", cfg=None) -> dict:
    """Phase 39's second part: arctic-480b's whole MoE layer (128 experts
    of d 7168 x f 4864 and its dense residual) on the card, its weights
    drawn and rounded to bf16 and held in float32 (53.6 GB), on B x S
    (``MOE_FULL``) standard normal rows: ``layers.MoE`` against
    ``layers.moe_plain`` (out within ``MOE_PLAIN_TOL`` of max |out|, aux
    within 1e-6 relative). The capacity (5 a row at S 256) must drop
    assignments, and both planted faults must fail the comparison. Then
    the router's columns are tied in threes: at least half the tokens tie
    exactly at the top-2 boundary, each routed to the lower two experts of
    its triple (``lax.top_k``'s order; ``torch.topk`` promises none), and
    ``MoE`` still equals ``moe_plain``. ``cfg`` replaces arctic-480b's
    float32 config (a rehearsal's)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import MoE, moe_plain

    _tf32_off(torch)
    t0 = time.perf_counter()
    cfg = cfg or get_config(ARCTIC, n_layers=MOE_CUT[ARCTIC][0], dtype="float32")
    B, S = MOE_FULL
    torch.cuda.empty_cache()
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(39)
        moe = MoE(cfg, device=dev)
        moe.init_(gen)
        for w in (moe.w_in, moe.w_out):
            for e in range(w.shape[0]):
                w[e].copy_(w[e].to(torch.bfloat16))
        for w in (moe.dense.w_in, moe.dense.w_out):
            w.copy_(w.to(torch.bfloat16))
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, aux = moe(x)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ref, ref_aux = moe_plain(moe, x)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _, _, _, idx = moe.route(x)
        _, keep, _, cap = moe.dispatch(idx, S)
        dropped = int((~keep).sum())
        err = rel_err(out, ref)
        aux_err = abs(float(aux) - float(ref_aux)) / abs(float(ref_aux))
        planted = {}
        for name, plant in (("no_renorm", planted_no_renorm),
                            ("no_capacity", planted_no_capacity)):
            with plant(moe):
                planted[name] = rel_err(moe(x)[0], ref)
        check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (B, S, cfg.d_model),
              f"MoE out of shape {tuple(out.shape)} or not finite")
        # the tie order on the card: router columns tied in threes, so a
        # token's best three experts tie exactly and lax.top_k keeps the
        # lower two
        n3 = cfg.n_experts // 3 * 3
        for j in (1, 2):
            moe.router[:, j:n3:3] = moe.router[:, 0:n3:3]
        _, probs, _, idx = moe.route(x)
        top = torch.sort(probs, dim=-1, descending=True)[0]
        tied = (top[..., 0] == top[..., 2]) & (idx[..., 0] < n3)
        lower = (idx[..., 0] % 3 == 0) & (idx[..., 1] == idx[..., 0] + 1)
        n_tied, n_lower = int(tied.sum()), int((tied & lower).sum())
        tie_err = rel_err(moe(x)[0], moe_plain(moe, x)[0])
        del moe, x, out, ref
    check(err <= MOE_PLAIN_TOL, f"MoE vs moe_plain at 128 experts: {err:.3e} > "
          f"{MOE_PLAIN_TOL:g} of max |out|")
    check(aux_err <= 1e-6, f"MoE vs moe_plain aux {float(aux)} vs {float(ref_aux)}")
    check(dropped > 0, f"the capacity {cap} dropped no assignment at S {S}")
    check(n_tied >= B * S // 2 and n_lower == n_tied and tie_err <= MOE_PLAIN_TOL,
          f"router tied in threes: {n_tied} of {B * S} tokens tie, {n_lower} of them "
          f"routed to the lower two experts; MoE vs moe_plain {tie_err:.3e}")
    for name, e in planted.items():
        check(e > MOE_PLAIN_TOL, f"the planted fault {name!r} passes MoE vs moe_plain "
              f"({e:.3e} <= {MOE_PLAIN_TOL:g})")
    rec = {"batch": B, "prompt_len": S, "experts": cfg.n_experts, "cap": cap,
           "dropped": dropped, "assignments": keep.numel(), "rel_err": err,
           "aux": float(aux), "aux_rel_err": aux_err, "planted": planted,
           "tied_tokens": n_tied, "tied_rel_err": tie_err,
           "moe_s": t2 - t1, "moe_plain_s": t3 - t2, "seconds": time.perf_counter() - t0}
    detail["moe_layer_vs_plain"] = rec
    log(f"[39] {cfg.name}'s MoE layer at full width ({cfg.n_experts} experts, float32 "
        f"holding bf16 weights), {B} x {S}: MoE vs moe_plain {err:.3e} of max |out| "
        f"(<= {MOE_PLAIN_TOL:g}), aux {float(aux):.6f} ({aux_err:.1e} apart); capacity {cap} "
        f"dropped {dropped} of {keep.numel()} assignments; planted faults: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items())
        + f" (all fail); router tied in threes: {n_tied} of {B * S} tokens tie at the "
        f"top-2 boundary, all routed to the lower two, MoE vs moe_plain {tie_err:.3e}; "
        f"first calls MoE {rec['moe_s']:.3f} s, moe_plain {rec['moe_plain_s']:.3f} s")
    return rec


def moe_phases(torch, rg, detail, rg_t, dev="cuda") -> dict:
    """Phases 38-41: serve arctic-480b (38) and kimi-k2-1t-a32b (40) at
    full width and ``MOE_SERVE_LAYERS`` layers (the xla path: no launch;
    arctic's head dim 128 then takes one blocked prefill on the flash
    kernel), and hold each to the CPU at the cut depth of ``MOE_CUT`` (39,
    41) with the routing-flip rule and the planted faults, and arctic's
    whole MoE layer to ``moe_plain`` on the card (39). Returns every
    wrapper's launches summed over the runs the four phases count (each
    checked run starts from zeroed counts; flash: the two blocked
    prefills', each read after its run), the flash launches of the first
    blocked prefill (all and tensor-core), and each phase's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers

    ws = wrappers()
    counted = dict.fromkeys(ws, 0)
    phase_s, t0 = {}, time.perf_counter()

    def tally(phase, runs=None):
        """Adds the launches of ``runs`` (each a run's counts), or else
        those on the counters, then zeroes the counters."""
        for run in runs or (_launches(ws),):
            for k, n in run.items():
                counted[k] += n
        _zero_launches(ws)
        phase_s[phase] = time.perf_counter() - t0 - sum(phase_s.values())

    _zero_launches(ws)
    logits = {}
    serve_phase(torch, rg, detail, rg_t, 38, ARCTIC, dev=dev,
                cfg=get_config(ARCTIC, n_layers=MOE_SERVE_LAYERS), logits_out=logits,
                shape=MOE_SERVE,
                after=lambda m, p, n: moe_serve_extras(torch, m, p, n, xla=logits))
    del logits
    blocked = detail[f"serve_{ARCTIC}"]["after"]["blocked"]
    check(_launches(ws) == blocked["twin_launches"],
          f"launches {_launches(ws)} after phase 38's last blocked prefill (the twin), "
          f"which counted {blocked['twin_launches']}")
    tally(38, blocked["launches"])
    for phase, arch in ((39, ARCTIC), (41, KIMI)):
        if phase == 41:
            serve_phase(torch, rg, detail, rg_t, 40, KIMI, dev=dev,
                        cfg=get_config(KIMI, n_layers=MOE_SERVE_LAYERS), shape=MOE_SERVE,
                        after=lambda m, p, n: moe_serve_extras(torch, m, p, n))
            tally(40)
        n_layers, n_experts, S = MOE_CUT[arch]
        devices_phase(torch, rg, detail, phase, arch, n_layers, S, dev=dev,
                      cfg_of=lambda dt, a=arch, n=n_layers, e=n_experts: get_config(
                          a, n_layers=n, n_experts=e, dtype=dt),
                      controls=MOE_CONTROLS[arch], routing=True)
        if phase == 39:
            moe_layer_phase(torch, detail, dev)
        tally(phase)
    check(counted == _want(ws, flash_attention=blocked["flash"] * len(blocked["launches"])),
          f"phases 38-41 launched {counted}; want only the blocked prefills' flash launches")
    detail["phases_38_41_s"] = phase_s
    detail["moe_launches"] = counted
    log("    phases 38-41 took " + ", ".join(f"{p}: {v:.1f} s" for p, v in phase_s.items())
        + "; launches: " + ", ".join(f"{k} {n}" for k, n in counted.items()))
    return {"launches": counted, "flash": blocked["flash"], "flash_tc": blocked["flash_tc"],
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phases 42-45: training arctic-480b and kimi-k2-1t-a32b
# ---------------------------------------------------------------------------

#: phases 42 and 44, MoE training at full width on one card: (layers, expert
#: counts, global batches), the candidates tried largest first (experts, then
#: batch); the first whose first step leaves ``FREE_GB`` of the card free is
#: trained. arctic-480b at 1 of 35 layers (14.07 B parameters: 28.1 GB of
#: bf16 masters and as much of gradients); kimi-k2-1t-a32b at its dense
#: prefix layer and one MoE layer with its 384 experts cut (at 384 its
#: masters and gradients alone are 78.3 GB)
MOE_TRAIN = {ARCTIC: (1, (128,), (4, 2)), KIMI: (2, (256, 192, 128), (2,))}
MOE_TRAIN_SEQ = 2048
FREE_GB = 5.0
#: phase 47: the mesh trainer's model and batch (one card, a 1x1 mesh)
MESH_TRAIN = ("qwen2-1.5b", 2, 2048)
#: phase 47: masters after two steps, mesh against no mesh (of max |p|)
MESH_MASTER_TOL = 1e-6
#: phase 47: the checkpoint round trip and the resize run at this depth (the
#: full model's 18.6 GB checkpoint took 67-84 s to write and read back)
MESH_RESIZE_LAYERS = 2
#: phase 48: the model-axis split on one card: the model, its depth (one
#: pattern unit: rglru, rglru, sliding), B x S and steps, on a (1, 2) mesh of
#: two gloo ranks; float32 compute, ``remat="full"``, AdamW
SPLIT_TRAIN = ("recurrentgemma-2b", 3, 2, 2048)
SPLIT_STEPS = 2
#: phase 48: each step's loss (relative) and the masters after the last step
#: (of max |p|), each rank against the meshless trainer
SPLIT_LOSS_TOL = 1e-5
SPLIT_MASTER_TOL = 1e-6
#: phase 48: the seconds the two ranks may take before they are killed
#: (the whole phase took 59.8-71.2 s on the H100)
SPLIT_TIMEOUT_S = 240
#: phase 49, serving on a (1, 2) mesh: gemma3-4b at full width, one
#: pattern unit (5 sliding layers of window 1024, 1 full layer) on the
#: blocked path with the config's tiles of 512 / 1024 (each rank's 1024
#: query rows are two tiles), bf16; (arch, layers, (B, S, decode steps)),
#: the weights' seed, and the seconds the ranks may take
MESH_SERVE = ("gemma3-4b", 6, (8, 2048, 8))
MESH_SERVE_CFG = {"attention_impl": "blocked", "attention_block_q": 512,
                  "attention_block_kv": 1024}
MESH_SERVE_SEED = 49
MESH_SERVE_TIMEOUT_S = 300
#: phase 49: decode steps of each planted fault's run (its prefill and these
#: steps are gated, the caches only after every step; with one step the
#: global-slot fault's attention outputs failed by only 6.5e-2 against the
#: 5e-2 gate on the H100: PERF.md, PR 29)
MESH_SERVE_PLANT_STEPS = 2
#: phases 43 and 45: a whole MoE layer's gradients, ``MoE`` against
#: ``moe_plain`` on the card, at full width with this many float32 experts
#: (arctic: 13.4 GB of weights, two gradient sets beside them), B x S of
#: ``MOE_FULL``
MOE_GRAD_EXPERTS = 32
#: phases 43 and 45 in bf16 (the configs' own dtypes: bf16 masters and
#: compute): the loss within one bf16 ulp relative (2**-8; the loss is
#: float32 over bf16 logits), every gradient leaf within ``BF16_GRAD_ULPS``
#: bf16 ulps of its max |g| (each device rounds the products, the
#: activations and the gradient itself to bf16 in its own order: the CPU
#: tests measure ~1e-2 of max |g| against JAX, 1.3-2.7 ulps), and one
#: Adafactor update on the same gradients within one bf16 ulp of each
#: updated weight (the two devices sum the float32 statistics in other
#: orders, which may round a weight to its other neighbour)
BF16_LOSS_REL, BF16_GRAD_ULPS = 2.0 ** -8, 8
#: phases 43 and 45: the Adafactor update compared card against CPU on the
#: MoE layers' leaves and norm scales, each cut along its leading axis to
#: its first expert or ``OPT_ROWS`` rows (the CPU's float32 elementwise
#: passes over every leaf would take minutes)
OPT_ROWS = 1024


def bf16_ulp(x):
    """The bf16 ulp at the magnitude of each of ``x``'s elements (2**-133,
    bf16's least subnormal step, at 0)."""
    import torch

    e = torch.frexp(x.float().abs()).exponent
    return torch.where(x == 0, torch.full_like(x.float(), 2.0 ** -133),
                       torch.ldexp(torch.ones_like(x.float()), e - 8))


#: the most elements ``grad_errors`` takes at once (float32 temporaries of a
#: whole kimi-k2 embedding gradient are 4.4 GiB each)
ERR_CHUNK = 1 << 24


def grad_errors(got: dict, want: dict, dtype: str) -> dict:
    """Per leaf, max |got - want| over max |want| (float32), or in bf16 ulps
    of max |want| (bfloat16); on the device the tensors share, in chunks of
    ``ERR_CHUNK`` elements (maxima are exact in any order)."""
    out = {}
    for path, ws in want.items():
        for g, w in zip(got[path], ws):
            g, w = g.reshape(-1), w.reshape(-1)
            spans = range(0, w.numel(), ERR_CHUNK)
            top = max(w[i:i + ERR_CHUNK].float().abs().max() for i in spans)
            diff = max((g[i:i + ERR_CHUNK].float() - w[i:i + ERR_CHUNK].float()).abs().max()
                       for i in spans)
            scale = top if dtype == "float32" else bf16_ulp(top)
            out[path] = max(out.get(path, 0.0), float(diff / scale))
    return out


@contextlib.contextmanager
def planted_no_aux(model):
    """A planted fault for phases 43 and 45: the MoE load-balancing term left
    out of the training loss (it moves the router's gradient)."""
    from repro_torch.models import model as model_module

    real = model_module.MOE_AUX_WEIGHT
    model_module.MOE_AUX_WEIGHT = 0.0
    try:
        yield
    finally:
        model_module.MOE_AUX_WEIGHT = real


#: phases 43 and 45's planted faults by model: (name, fault, gate), gated on
#: the card's gradients against the CPU's. The capacity ignored where the
#: CPU's step drops an assignment; the aux term left out and kimi-k2-1t-a32b's
#: unnormalised gates in float32 only, as in phase 41: the router's gradient
#: comes through its bf16 product, and at full width the aux term moves it
#: by 2 bf16 ulps of its max (arctic), under the bf16 gate
_NO_CAPACITY_TRAIN = ("no_capacity", planted_no_capacity,
                      lambda dtype, rec: rec["dropped"] > 0)
MOE_TRAIN_CONTROLS = {
    ARCTIC: (("no_aux", planted_no_aux, ("float32",)), _NO_CAPACITY_TRAIN),
    KIMI: (("no_aux", planted_no_aux, ("float32",)), _NO_CAPACITY_TRAIN,
           ("no_renorm", planted_no_renorm, ("float32",)))}


def timed_updates(torch, trainer, walls: list) -> None:
    """Has ``trainer``'s train step append each optimizer update's wall
    seconds, the device synced before and after, to ``walls``."""
    import dataclasses

    from repro_torch.runtime import make_train_step

    opt = trainer.optimizer

    def update(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = opt.update(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    trainer._step = make_train_step(trainer.cfg, dataclasses.replace(opt, update=update))


def moe_train_phase(torch, detail, phase: int, arch: str, dev="cuda") -> dict:
    """Phases 42 and 44: train ``arch`` at full width and ``MOE_TRAIN``'s
    depth through ``runtime.Trainer`` with ``TrainerConfig(optimizer=
    "adafactor")``: bf16 masters and compute, the config's ``remat`` and
    ``logits_chunk``, the seeded pipeline's Zipf tokens, S
    ``MOE_TRAIN_SEQ``, TF32 off, 3 steps on the largest candidate (experts,
    then batch) whose first step leaves ``FREE_GB`` of the card free (a
    candidate that runs out of memory, or leaves less, is recorded and
    freed). No kernel wrapper launches, the losses are finite and a second
    run's first loss is the first's bit for bit. Reports the step time,
    tokens/s, peak memory, the optimizer updates' share of the steps, the
    model-FLOP share by ``costs.model_flops`` (active parameters) and by 6 x
    ``numel`` (every expert), and one profiled step's device idle share
    and top kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.models import costs
    from repro_torch.models.config import ShapeCell
    from repro_torch.runtime import Trainer, TrainerConfig

    _tf32_off(torch)
    t_start = time.perf_counter()
    n_layers, experts, batches = MOE_TRAIN[arch]
    S, steps = MOE_TRAIN_SEQ, 3
    ws = wrappers()
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    tried, trainer = [], None
    for E in experts:
        for B in batches:
            cfg = get_config(arch, n_layers=n_layers, n_experts=E)
            tcfg = TrainerConfig(seq_len=S, global_batch=B, total_steps=steps,
                                 optimizer="adafactor")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, tcfg, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            opt_walls, walls, per_step, losses = [], [], [], []
            timed_updates(torch, trainer, opt_walls)
            _zero_launches(ws)
            try:
                t0 = time.perf_counter()
                losses.append(trainer.run(1)["losses"][0])
                walls.append(time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError:
                peak = None
            else:
                peak = torch.cuda.max_memory_allocated() / 1e9
            free = None if peak is None else total_gb - peak
            tried.append({"experts": E, "batch": B, "peak_gb": peak, "free_gb": free})
            if free is not None and free >= FREE_GB:
                break
            del trainer
            trainer = None
            torch.cuda.empty_cache()
        if trainer is not None:
            break
    check(trainer is not None, f"{arch}: no candidate of {tried} leaves {FREE_GB:g} GB free")
    per_step.append(_launches(ws))
    while len(walls) < steps:
        before = _launches(ws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.run(1)["losses"][0])
        walls.append(time.perf_counter() - t0)
        per_step.append({k: n - before[k] for k, n in _launches(ws).items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    masters = {str(p.dtype) for p in trainer.state.model.parameters()}
    step_s = sum(walls[1:]) / len(walls[1:])
    opt_s = sum(opt_walls[1:steps]) / len(opt_walls[1:steps])
    kernels = device_kernels(torch, lambda: trainer.run(1))
    del trainer
    torch.cuda.empty_cache()
    again = Trainer(cfg, tcfg, device=dev)
    first = again.run(1)["losses"][0]
    del again
    torch.cuda.empty_cache()
    check(first == losses[0], f"{arch}: a second run's first loss {first!r} differs from "
          f"{losses[0]!r}")
    check(all(p == _want(ws) for p in per_step), f"{arch}: kernel launches per step "
          f"{per_step}; want none")
    check(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    check(masters == {"torch.bfloat16", "torch.float32"}, f"{arch}: master dtypes {masters}")
    busy_ms = sum(k["device_ms"] for k in kernels)
    flops = costs.model_flops(cfg, ShapeCell(f"train_{B}x{S}", "train", S, B))
    real_flops = 6.0 * n_params * B * S
    out = {"layers": n_layers, "experts": E, "batch": B, "seq_len": S, "steps": steps,
           "candidates": tried, "init_s": init_s, "step_s": walls, "losses": losses,
           "steady_step_s": step_s, "tokens_per_s": B * S / step_s,
           "optimizer_s": opt_walls[:steps], "optimizer_share": opt_s / step_s,
           "peak_memory_gb": peak_gb, "free_gb": total_gb - peak_gb,
           "params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "numel": n_params, "model_flops_per_step": flops,
           "model_tflop_s": flops / step_s / 1e12,
           "bf16_tc_share": flops / step_s / BF16_TC_FLOPS,
           "numel_flops_per_step": real_flops,
           "numel_bf16_tc_share": real_flops / step_s / BF16_TC_FLOPS,
           "launches_per_step": per_step, "second_run_first_loss": first,
           "profiled_step": {"device_busy_ms": busy_ms,
                             "idle_share": 1.0 - busy_ms / 1e3 / step_s,
                             "top_kernels": kernels[:15]},
           "seconds": time.perf_counter() - t_start}
    detail[f"train_{arch}"] = out
    log(f"[{phase}] {cfg.name} ({n_layers} layer{'s' if n_layers > 1 else ''}, {E} experts, "
        f"top-{cfg.top_k}) training at full width, {B} x {S} tokens a step, bf16 masters, "
        f"Adafactor, remat {cfg.remat!r} (init {init_s:.2f} s; candidates "
        + ", ".join(f"{c['experts']} experts x B {c['batch']}: "
                    + ("out of memory" if c["peak_gb"] is None
                       else f"{c['free_gb']:.2f} GB free") for c in tried)
        + f"): steps {', '.join(f'{w:.3f}' for w in walls)} s, {out['tokens_per_s']:.0f} "
        f"tokens/s (steps 2-{steps}); the optimizer {opt_s:.3f} s a step "
        f"({out['optimizer_share']:.1%}); model FLOPs (active parameters) "
        f"{flops / 1e12:.1f} T a step, {out['model_tflop_s']:.1f} TFLOP/s, "
        f"{out['bf16_tc_share']:.2%} of the bf16 tensor-core peak; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; no kernel launch; peak {peak_gb:.2f} GB "
        f"of {total_gb:.2f}; a second run's first loss identical")
    log(f"    model FLOPs by 6 x numel ({n_params / 1e9:.2f} B, every expert): "
        f"{real_flops / 1e12:.1f} T a step, {out['numel_bf16_tc_share']:.2%} of the bf16 "
        f"tensor-core peak; one profiled step: kernels busy {busy_ms:.1f} ms (device idle "
        f"{out['profiled_step']['idle_share']:.1%} of an untraced step); top: " + "; ".join(
            f"{k['op'][:48]} {k['device_ms']:.1f} ms x{k['count']}" for k in kernels[:5]))
    return out


def moe_grad_phase(torch, detail, phase: int, arch: str, dev="cuda", cfg=None) -> dict:
    """Phases 43 and 45's last part: one MoE layer of ``arch`` at full width
    with ``MOE_GRAD_EXPERTS`` float32 experts on the card, B x S of
    ``MOE_FULL`` rows (standard normal around one shared normal direction):
    the gradients of ``sum(out * r) +
    aux`` (``r`` a seeded normal cotangent) through ``layers.MoE`` and
    through ``layers.moe_plain``, for x, the router, ``w_in``, ``w_out``
    and the shared expert or dense residual, each within
    ``MOE_PLAIN_TOL`` of its max; the capacity must drop assignments.
    ``cfg`` replaces the float32 config (a rehearsal's)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import MoE, moe_plain

    _tf32_off(torch)
    t0 = time.perf_counter()
    cfg = cfg or get_config(arch, n_layers=1, n_experts=MOE_GRAD_EXPERTS, dtype="float32",
                            param_dtype="float32")
    B, S = MOE_FULL
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(phase)
    moe = MoE(cfg, device=dev, trainable=True)
    with torch.no_grad():
        moe.init_(gen)
    # rows around one shared direction: the router favours some experts, so
    # the capacity drops assignments at kimi's top-8 too
    x = (torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
         + torch.randn((cfg.d_model,), generator=gen, device=dev)).requires_grad_()
    r = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    grads = []
    for fn in (lambda: moe(x), lambda: moe_plain(moe, x)):
        moe.zero_grad(set_to_none=True)
        x.grad = None
        out, aux = fn()
        (torch.sum(out * r) + aux).backward()
        grads.append({"x": x.grad, **{n: p.grad for n, p in moe.named_parameters()}})
    with torch.no_grad():
        _, _, _, idx = moe.route(x)
        _, keep, _, cap = moe.dispatch(idx, S)
    dropped = int((~keep).sum())
    errs = {k: rel_err(g, grads[1][k]) for k, g in grads[0].items()}
    worst = max(errs, key=errs.get)
    del moe, x, r, grads
    torch.cuda.empty_cache()
    check(dropped > 0, f"{arch}: the capacity {cap} dropped no assignment at S {S}")
    check(errs[worst] <= MOE_PLAIN_TOL, f"{arch}: MoE vs moe_plain gradient of {worst}: "
          f"{errs[worst]:.3e} of its max > {MOE_PLAIN_TOL:g}")
    rec = {"experts": cfg.n_experts, "batch": B, "prompt_len": S, "cap": cap,
           "dropped": dropped, "assignments": keep.numel(), "grad_rel_err": errs,
           "seconds": time.perf_counter() - t0}
    detail[f"moe_grad_vs_plain_{arch}"] = rec
    log(f"[{phase}] {cfg.name}'s MoE layer at full width ({cfg.n_experts} float32 experts), "
        f"{B} x {S}: gradients through MoE vs moe_plain, worst {worst} {errs[worst]:.3e} "
        f"of its max (<= {MOE_PLAIN_TOL:g}; " + ", ".join(f"{k} {v:.1e}" for k, v in
                                                          errs.items())
        + f"); capacity {cap} dropped {dropped} of {keep.numel()} assignments "
        f"({rec['seconds']:.1f} s)")
    return rec


def moe_opt_leaves(leaves: dict) -> dict:
    """The leaves of a model's MoE layers (router, experts, shared expert,
    dense residual) and their layers' norm scales, each cut along its
    leading axis to its first expert or ``OPT_ROWS`` rows (views, so an
    update writes into the model)."""
    return {path: [p[:1] if p.dim() > 2 else p[:OPT_ROWS] for p in ps]
            for path, ps in leaves.items()
            if path.startswith("units/") and ("/ffn/" in path or path.endswith("/scale"))}


def moe_train_devices_phase(torch, detail, phase: int, arch: str, dev="cuda",
                            cfg_of=None) -> dict:
    """Phases 43 and 45: one training step of ``arch`` on the card against
    the CPU at full width and ``MOE_CUT``'s depth, experts and length, B 1,
    the same weights (drawn on the card, copied to the CPU): in float32
    (masters and compute) and at the config's own dtypes (bf16). The card
    runs the config's ``remat`` and taps each MoE layer's routing with its
    input (the recompute must route as the forward); the CPU computes the
    same function without the recompute (``remat="none"``), routed as the
    card (``forced_routes``), and routes the card's MoE inputs itself, every
    flip a near-tie on at most ``FLIP_ROWS_MAX`` of the rows
    (``card_cpu_routes``). The loss and every gradient leaf within
    ``TRAIN_LOSS_REL`` / ``TRAIN_GRAD_SHARE`` (float32) or
    ``BF16_LOSS_REL`` / ``BF16_GRAD_ULPS`` (bf16); a second identical step
    on the card gives bit-equal gradients; each of ``MOE_TRAIN_CONTROLS``
    planted on the card must fail the gradient check where it is gated;
    one Adafactor update of ``moe_opt_leaves`` on the card's gradients,
    card against CPU: within ``OPT_CARD_CPU`` of max |p| (float32) or one
    bf16 ulp of each weight. No kernel wrapper launches. Then
    :func:`moe_grad_phase`."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import wrappers
    from repro_torch.models import init_params, loss_fn, param_leaves
    from repro_torch.optim import make_optimizer

    # half the serving comparison's length since PR 27 (the time limit: the
    # CPU's full-width steps are the phase's cost)
    n_layers, n_experts, S = MOE_CUT[arch][:2] + (MOE_CUT[arch][2] // 2,)
    cfg_of = cfg_of or (lambda dt: get_config(arch, n_layers=n_layers, n_experts=n_experts,
                                              dtype=dt, param_dtype=dt))
    ws = wrappers()
    out = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = cfg_of(dtype)
        card_model = init_params(cfg, torch.Generator(device=dev).manual_seed(phase),
                                 trainable=True)
        cpu_model = copy.deepcopy(card_model).cpu()
        cpu_model.cfg = dataclasses.replace(cfg, remat="none")
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, S, 1, seed=phase).items()}
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        n = len(moe_layers(card_model))
        card_leaves, cpu_leaves = param_leaves(card_model), param_leaves(cpu_model)
        parts, mark = {}, [t0]

        def lap(name):
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - mark[0]
            mark[0] = time.perf_counter()

        lap("setup")

        def card_step():
            card_model.zero_grad(set_to_none=True)
            loss = loss_fn(card_model, card_batch)
            loss.backward()
            return loss.detach(), {k: [p.grad for p in ps] for k, ps in card_leaves.items()}

        _zero_launches(ws)
        with tapped_routes(card_model, keep_x=True) as card_calls:
            card_loss, card_grads = card_step()
        launched = _launches(ws)
        recompute = card_calls[n:]
        check(len(recompute) == (n if cfg.remat != "none" else 0) and all(
            torch.equal(a["idx"], b["idx"]) and torch.equal(a["kept"], b["kept"])
            for a, b in zip(card_calls[:n], recompute)),
            f"{arch} {dtype}: the recompute's routes differ from the forward's")
        card_calls = card_calls[:n]
        again_loss, again = card_step()
        same = torch.equal(again_loss, card_loss) and all(
            torch.equal(a, b) for k, gs in card_grads.items() for a, b in zip(gs, again[k]))
        del again
        lap("card_steps")
        with forced_routes(cpu_model, card_calls), tapped_routes(cpu_model) as cpu_calls:
            cpu_loss = loss_fn(cpu_model, batch)
            cpu_loss.backward()
        cpu_loss = cpu_loss.detach()
        lap("cpu_step")
        flips = card_cpu_routes(cpu_model, cpu_calls, card_calls, dtype)
        flips["dropped"] = sum(int((~c["kept"]).sum()) for c in cpu_calls)
        # the CPU's gradients on the card, where the comparisons run
        cpu_grads = {k: [p.grad.to(dev) for p in ps] for k, ps in cpu_leaves.items()}
        loss_err = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
        errs = grad_errors(card_grads, cpu_grads, dtype)
        worst = max(errs, key=errs.get)
        tol = TRAIN_GRAD_SHARE if dtype == "float32" else BF16_GRAD_ULPS
        planted = {}
        for name, plant, gated in MOE_TRAIN_CONTROLS[arch]:
            with plant(card_model):
                _, bad = card_step()
            e = grad_errors(bad, cpu_grads, dtype)
            bad_worst = max(e, key=e.get)
            on = gated(dtype, flips) if callable(gated) else dtype in gated
            planted[name] = {"err": e[bad_worst], "leaf": bad_worst, "gated": on,
                             "router": max(v for k, v in e.items() if k.endswith("router"))}
            del bad
        lap("planted")
        # one Adafactor update of the MoE layers' leaves on the card's
        # gradients, on the card and on the CPU
        opt = make_optimizer("adafactor", peak_lr=1e-2, warmup=0, total=100)
        card_p, cpu_p = moe_opt_leaves(card_leaves), moe_opt_leaves(cpu_leaves)
        g_card = {k: [g[:p.shape[0]] for g, p in zip(card_grads[k], card_p[k])]
                  for k in card_p}
        del card_grads
        cpu_model.zero_grad(set_to_none=True)
        del cpu_grads
        g_cpu = {k: [g.cpu() for g in gs] for k, gs in g_card.items()}
        before = {k: [p.detach().clone() for p in ps] for k, ps in cpu_p.items()}
        with torch.no_grad():
            opt.update(g_card, opt.init(card_p), card_p, 0)
            opt.update(g_cpu, opt.init(cpu_p), cpu_p, 0)
        if dtype == "float32":
            opt_err = max(rel_err(q.detach().cpu(), p.detach())
                          for k, ps in cpu_p.items() for p, q in zip(ps, card_p[k]))
            opt_ok = opt_err <= OPT_CARD_CPU
        else:  # in ulps of the larger of each weight before and after
            opt_err = max(float(((q.detach().cpu().float() - p.detach().float()).abs()
                                 / bf16_ulp(torch.maximum(p.detach().abs(), b.abs()))).max())
                          for k, ps in cpu_p.items()
                          for p, q, b in zip(ps, card_p[k], before[k]))
            opt_ok = opt_err <= 1.0
        lap("adafactor")
        del g_card, g_cpu, card_p, cpu_p, cpu_model, card_model
        torch.cuda.empty_cache()
        loss_tol = TRAIN_LOSS_REL if dtype == "float32" else BF16_LOSS_REL
        unit = "of each leaf's max |g|" if dtype == "float32" else "bf16 ulps of its max |g|"
        check(math.isfinite(float(card_loss)) and loss_err <= loss_tol,
              f"{arch} {dtype}: card loss {float(card_loss)!r} vs CPU {float(cpu_loss)!r}: "
              f"{loss_err:.3e} > {loss_tol:g}")
        check(errs[worst] <= tol, f"{arch} {dtype}: card vs CPU gradient of {worst}: "
              f"{errs[worst]:.3e} {unit} > {tol:g}")
        check(launched == _want(ws), f"{arch} {dtype}: kernel launches {launched}; want none")
        check(same, f"{arch} {dtype}: a second identical step on the card gives other "
              f"gradients")
        check(flips["unjustified"] == 0 and flips["kept_unexplained"] == 0,
              f"{arch} {dtype}: on the card's MoE inputs {flips['unjustified']} of "
              f"{flips['device_tokens']} routing flips between the devices are not "
              f"near-ties, {flips['kept_unexplained']} kept flags differ behind no flip")
        check(flips["device_rows"] <= FLIP_ROWS_MAX * flips["rows_of"],
              f"{arch} {dtype}: routing flips change {flips['device_rows']} of "
              f"{flips['rows_of']} rows (> {FLIP_ROWS_MAX:.0%})")
        for name, ctl in planted.items():
            check(not ctl["gated"] or ctl["err"] > tol, f"{arch} {dtype}: the planted fault "
                  f"{name!r} passes the gradient check ({ctl['err']:.3e} <= {tol:g})")
        check(opt_ok, f"{arch} {dtype}: Adafactor on the card vs the CPU, same gradients: "
              f"{opt_err:.3e} " + ("of max |p|" if dtype == "float32" else "bf16 ulps"))
        out[dtype] = {"loss_card": float(card_loss), "loss_cpu": float(cpu_loss),
                      "loss_rel_err": loss_err, "grad_err": errs, "worst_grad_leaf": worst,
                      "bit_equal_repeat": same, "routing": flips,
                      "planted": planted, "adafactor_err": opt_err, "seconds_by_part": parts,
                      "seconds": time.perf_counter() - t0}
        log(f"[{phase}] {cfg.name} n_layers={cfg.n_layers}, {cfg.n_experts} experts, {dtype} "
            f"masters and compute, 1 x {S}, one step (card remat {cfg.remat!r}, CPU none): "
            f"card vs CPU loss {loss_err:.3e} (<= {loss_tol:g}), gradients {errs[worst]:.3e} "
            f"{unit} over {len(errs)} leaves (<= {tol:g}; worst {worst}); a second card step "
            f"bit-equal; the recompute routed as the forward; Adafactor on the card's "
            f"gradients (MoE leaves, an expert or {OPT_ROWS} rows each), card vs CPU "
            f"{opt_err:.3e} "
            + ("of max |p|" if dtype == "float32" else "bf16 ulps (<= 1)")
            + f"; no kernel launch ({out[dtype]['seconds']:.1f} s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
        log(f"    routing: on the card's MoE input the CPU routes {flips['device_tokens']} "
            f"tokens to another set of experts, all near-ties ({flips['device_rows']} of "
            f"{flips['rows_of']} rows); on its own input {flips['tokens']} tokens; the CPU "
            f"dropped {flips['dropped']} assignments")
        for name, ctl in planted.items():
            log(f"    planted fault {name!r} on the card: gradients {ctl['err']:.3e} {unit} "
                f"(worst {ctl['leaf']}; the router {ctl['router']:.3e}; tolerance {tol:g}"
                f"{'' if ctl['gated'] else '; not gated here'})")
    detail[f"train_card_vs_cpu_{arch}"] = out
    out["moe_grad"] = moe_grad_phase(torch, detail, phase, arch, dev)
    return out


def moe_train_phases(torch, detail, dev="cuda") -> dict:
    """Phases 42-45: train arctic-480b (42) and kimi-k2-1t-a32b (44) at full
    width on one card, each followed by its training step card against CPU
    and its MoE layer's gradients against ``moe_plain`` (43, 45). Returns
    every wrapper's launches summed over the four phases (each checked run
    starts from zeroed counts) and each phase's seconds."""
    from repro_torch.kernels import wrappers

    ws = wrappers()
    counted = dict.fromkeys(ws, 0)
    phase_s, t0 = {}, time.perf_counter()
    _zero_launches(ws)
    for phase, arch in ((42, ARCTIC), (43, ARCTIC), (44, KIMI), (45, KIMI)):
        if phase in (42, 44):
            moe_train_phase(torch, detail, phase, arch, dev)
        else:
            moe_train_devices_phase(torch, detail, phase, arch, dev)
        for k, n in _launches(ws).items():
            counted[k] += n
        _zero_launches(ws)
        phase_s[phase] = time.perf_counter() - t0 - sum(phase_s.values())
    check(counted == _want(ws), f"phases 42-45 launched {counted}; want none")
    detail["phases_42_45_s"] = phase_s
    log("    phases 42-45 took " + ", ".join(f"{p}: {v:.1f} s" for p, v in phase_s.items())
        + "; launches: " + ", ".join(f"{k} {n}" for k, n in counted.items()))
    return {"launches": counted, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phases 26-29: scheduled training, the chaos engine and the journal
# ---------------------------------------------------------------------------

#: phase 26's two calls of ``launch.train.run_scheduled``: (scheduler,
#: tenants, rounds); the first is the JAX launcher's defaults
SCHED_RUNS = (("oef-coop", "qwen2-1.5b,gemma3-4b,xlstm-350m", 3),
              ("oef-noncoop", "recurrentgemma-2b,qwen2-1.5b", 2))
#: phase 26's sequence length and global batch (the JAX launcher's defaults)
SCHED_SHAPE = (128, 8)
#: phase 27's cells, (tenants, scale, until) as ``service_trace`` takes
#: them: phase 4's full-size non-coop replay, cut to its first 600 s (21
#: solves, every planned solver fault fired on the CPU; 41 at 1200 s), and
#: phase 5's 128 tenants, replayed on the card and on the CPU
CHAOS_FULL = (1024, 128, 600.0)
CHAOS_SMALL = (128, 16, 7200.0)
#: phases 28-29, (policy, tenants, scale, until): phase 8's coop replay and
#: phase 5's 128-tenant non-coop one, journaled, killed at the median event
#: time and resumed
#: phase 28's coop replay at 128 tenants since PR 27 (256 before: the time
#: limit; phase 8 replays 256 coop tenants on the card)
JOURNAL_CELLS = {28: ("oef-coop", 128, 16, 7200.0),
                 29: ("oef-noncoop", 128, 16, 7200.0)}
JOURNAL_SNAPSHOT_EVERY = 50


def report_view(report) -> str:
    """A report minus its two wall-clock latency fields, as repr (NaN !=
    NaN under ==): the comparison of ``tests/test_chaos.py``'s ``_view``."""
    import dataclasses

    d = dataclasses.asdict(report)
    d.pop("resolve_latency_ms_mean")
    d.pop("resolve_latency_ms_p95")
    return repr(d)


def same_decisions(a, b, what: str) -> float:
    """Two replays made the same decisions (phase 5's criteria): solves,
    finished jobs and events equal, mean JCT within 1e-6 relative, each
    tenant's throughput within 1e-6. Returns the largest throughput
    difference."""
    check((a.n_solves, a.jobs_finished, a.n_events)
          == (b.n_solves, b.jobs_finished, b.n_events),
          f"{what}: the replays made different decisions")
    check(abs(a.mean_jct_s - b.mean_jct_s) <= 1e-6 * max(a.mean_jct_s, 1.0),
          f"{what}: mean JCT differs")
    d_tp = max(abs(a.tenant_throughput[t] - b.tenant_throughput[t])
               for t in a.tenant_throughput)
    check(d_tp <= 1e-6, f"{what}: tenant throughput differs by {d_tp:.3e}")
    return d_tp


def sched_rglru_shape() -> tuple:
    """The (B, S, D) of the RG-LRU scans that phase 26's recurrentgemma-2b
    tenant runs: the global batch, the sequence and the smoke config's
    width (float32, from a zero state). Phases 10 and 15 hold both kernels
    to their plain versions there."""
    from repro_torch.configs import get_smoke

    seq_len, batch = SCHED_SHAPE
    return (batch, seq_len, get_smoke("recurrentgemma-2b").d_model)


def sched_train_phase(torch, np, detail, dev="cuda") -> dict:
    """Phase 26: OEF-scheduled multi-tenant training through
    ``launch.train.run_scheduled``, each tenant's smoke model on ``dev``.
    Each tenant must take the steps of its grant (the schedule is
    ``schedule_rounds``', numpy on the host, which
    ``tests/test_torch_sched_train.py`` holds to the JAX package), every
    loss be finite, and every wrapper's launches exact: the RG-LRU kernels'
    for recurrentgemma-2b's steps, the sLSTM kernels' for xlstm-350m's, none
    for any other tenant.
    Returns the RG-LRU (forward, backward, by route) and sLSTM launches, by
    name."""
    from argparse import Namespace

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wrappers
    from repro_torch.launch import train as train_cli

    ws = wrappers()
    seq_len, batch = SCHED_SHAPE
    out = {}
    rglru = dict.fromkeys(("rglru_scan", "rglru_scan_tma", "rglru_scan_backward",
                           "rglru_scan_backward_tma", "slstm_scan", "slstm_scan_backward"), 0)
    for scheduler, tenants, rounds in SCHED_RUNS:
        names = tenants.split(",")
        args = Namespace(scheduler=scheduler, tenants=tenants, rounds=rounds,
                         seq_len=seq_len, batch=batch, lr=3e-4, device=dev)
        _zero_launches(ws)
        rg.rglru_scan.launches_tma = rg.rglru_scan_backward.launches_tma = 0
        t0 = time.perf_counter()
        got = train_cli.run_scheduled(args)
        wall = time.perf_counter() - t0
        total = _launches(ws)
        tma = (rg.rglru_scan.launches_tma, rg.rglru_scan_backward.launches_tma)
        label = f"{scheduler} {tenants}"
        check(len(got["rounds"]) == rounds == len(got["schedule"]["rounds"]),
              f"{label}: {len(got['rounds'])} rounds")
        want_total = _want(ws)
        rec = []
        for r, w in enumerate(got["schedule"]["rounds"]):
            per = {}
            for name in names:
                t = got["rounds"][r]["tenants"][name]
                steps = w["steps"][name]
                check(len(t["losses"]) == steps
                      and all(math.isfinite(x) for x in t["losses"]),
                      f"{label}, round {r}, {name}: {len(t['losses'])} losses for "
                      f"{steps} steps, or one not finite")
                launches = _want(ws, **{k: steps * n for k, n in
                                        step_launches(get_smoke(name)).items()})
                check(t["launches"] == launches,
                      f"{label}, round {r}, {name}: launches {t['launches']}, "
                      f"want {launches}")
                for k, n in launches.items():
                    want_total[k] += n
                per[name] = {"steps": steps, "seconds": t["seconds"],
                             "steps_per_s": steps / t["seconds"],
                             "first_loss": t["losses"][0], "last_loss": t["losses"][-1]}
            rec.append({"grants": np.asarray(w["grants"]).tolist(),
                        "wall_s": got["rounds"][r]["wall_s"], "tenants": per})
            log(f"[26] {label}, round {r}: wall {got['rounds'][r]['wall_s']:.2f} s; "
                + "; ".join(f"{n} {p['steps']} steps {p['seconds']:.2f} s "
                            f"({p['steps_per_s']:.2f} steps/s, loss "
                            f"{p['last_loss']:.4f})" for n, p in per.items()))
        check(total == want_total, f"{label}: launches {total}, want {want_total}")
        n_steps = sum(p["steps"] for r in rec for p in r["tenants"].values())
        for name, n in (("rglru_scan", total["rglru_scan"]), ("rglru_scan_tma", tma[0]),
                        ("rglru_scan_backward", total["rglru_scan_backward"]),
                        ("rglru_scan_backward_tma", tma[1]),
                        ("slstm_scan", total["slstm_scan"]),
                        ("slstm_scan_backward", total["slstm_scan_backward"])):
            rglru[name] += n
        out[label] = {"rounds": rec, "wall_s": wall, "steps": n_steps,
                      "steps_per_s": n_steps / wall, "launches": total,
                      "launches_tma": list(tma)}
        log(f"    {label}: {n_steps} steps in {wall:.2f} s ({n_steps / wall:.2f} "
            f"steps/s, trainers' build included), each tenant its granted "
            f"steps, RG-LRU launches {total['rglru_scan']} forward "
            f"({tma[0]} TMA), {total['rglru_scan_backward']} backward ({tma[1]} "
            f"TMA), sLSTM {total['slstm_scan']} forward, {total['slstm_scan_backward']} "
            f"backward, no other kernel")
    detail["sched_train"] = out
    return rglru


def chaos_replay(n_tenants: int, scale: int, until: float, device: str, plan,
                 tracer=None, sink=None):
    """``service_trace``'s trace merged with ``plan`` by ``chaos_trace`` and
    replayed on ``oef-noncoop``, ``backend="torch"`` on ``device``, with
    the engine installed on that chain."""
    from repro_torch import obs
    from repro_torch.service import ChaosEngine, OnlineScheduler

    cluster, base = service_trace(n_tenants, scale)
    engine = ChaosEngine(plan, cluster)
    events = engine.chaos_trace(base)
    sched = OnlineScheduler(cluster, "oef-noncoop", min_resolve_interval_s=30.0,
                            solver_backend="torch", device=device)
    if tracer is not None:
        obs.set_tracer(tracer)
    if sink is not None:
        obs.set_metrics(obs.MetricsRegistry(sink=sink))
    t0 = time.perf_counter()
    try:
        with engine.installed(backend="torch"):
            report = sched.run(events, until=until)
    finally:
        if tracer is not None:
            obs.set_tracer(None)
        if sink is not None:
            obs.set_metrics(None)
    return sched, report, engine, time.perf_counter() - t0


def ladder(sched) -> dict:
    """What the guardrail ladder made of a run's solver faults: the solves
    that a fallback backend answered and the solves stamped degraded (a
    reused solve runs no solver and is neither, though it carries its
    predecessor's ``fallback_reason`` into the report's ``fallback_count``)."""
    solved = [s for s in sched.metrics.solves if not s.reused]
    return {"fallback_solves": sum(1 for s in solved if s.fallback_reason),
            "degraded": sum(1 for s in solved if s.degraded)}


def chaos_phase(np, detail, dev="cuda") -> int:
    """Phase 27: the standard fault storm (``standard_plan(0)``) on the
    non-coop torch tier. At 128 tenants the card and the CPU make the same
    decisions and the same faults fire; the CPU run says what the ladder
    makes of the plan (a transient fault retried, a crash or a timeout
    answered by the LP and degraded). At full size every planned solver
    fault fires, the ladder does the same, ``waterfill_solve`` is launched
    once per torch attempt that got past the wrapper and no other kernel
    runs; the run's trace and metrics files are read back by
    ``obs.report``. Returns the fused solve's launches."""
    import tempfile

    from repro_torch import obs
    from repro_torch.kernels import wrappers
    from repro_torch.obs.report import report_lines
    from repro_torch.service import standard_plan

    plan = standard_plan(seed=0)
    kinds = [k for _, k in plan.solver_faults]
    planned = {"fallback_solves": kinds.count("crash") + kinds.count("timeout")}
    planned["degraded"] = planned["fallback_solves"]
    ws = wrappers()
    runs = {}
    for label, device in (("cuda", dev), ("cpu", "cpu")):
        sched, rep, engine, w = chaos_replay(*CHAOS_SMALL, device, plan)
        runs[label] = (sched, rep, engine.summary())
        log(f"[27] {CHAOS_SMALL[0]} tenants, standard_plan(0), {label:4s}: "
            f"{rep.n_solves} solves, {rep.jobs_finished} jobs, {rep.n_events} "
            f"events, wall {w:.1f} s, backends {rep.solver_backends}, "
            f"{runs[label][2]['solver_faults_fired']} solver faults fired, "
            f"ladder {ladder(sched)}")
    (s_cpu, a, sum_cpu), (s_card, b, sum_card) = runs["cpu"], runs["cuda"]
    d_tp = same_decisions(a, b, f"chaos at {CHAOS_SMALL[0]} tenants, card vs CPU")
    check(sum_cpu == sum_card, f"chaos summaries differ: CPU {sum_cpu}, card {sum_card}")
    derived = ladder(s_cpu)
    check(derived == planned and a.degraded_solves == derived["degraded"],
          f"the CPU run's ladder {derived} (report degraded {a.degraded_solves}), "
          f"the plan's {planned}")
    check(ladder(s_card) == derived, f"the card's ladder {ladder(s_card)}")

    _zero_launches(ws)
    with tempfile.TemporaryDirectory() as d:
        tpath, mpath = os.path.join(d, "trace.json"), os.path.join(d, "metrics.jsonl")
        tracer = obs.Tracer()
        sink = obs.JsonlSink(mpath)
        try:
            sched, rep, engine, wall = chaos_replay(*CHAOS_FULL, dev, plan,
                                                    tracer=tracer, sink=sink)
        finally:
            sink.close()
        launches = _launches(ws)
        tracer.save(tpath)
        lines = report_lines([tpath, mpath])
    summary = engine.summary()
    fired = summary["solver_faults_fired"]
    torch_attempts = summary["attempts"].get("oef-noncoop/torch", 0)
    reached = torch_attempts - fired
    got = ladder(sched)
    log(f"    {CHAOS_FULL[0]} tenants / {3 * 8 * CHAOS_FULL[1]} devices, until "
        f"{CHAOS_FULL[2]:g} s: {rep.n_solves} solves, {rep.n_events} events, wall "
        f"{wall:.1f} s (traced, metrics on); {fired} solver faults fired "
        f"({summary['stats']}), attempts {summary['attempts']}, ladder {got}, "
        f"report fallback_count {rep.fallback_count}, degraded "
        f"{rep.degraded_solves}, quarantines "
        f"{sum(1 for e in rep.quarantine_events if e['action'] == 'quarantine')}, "
        f"{launches['waterfill_solve']} fused-solve launches")
    check(fired == len(plan.solver_faults),
          f"{fired} solver faults fired, the plan has {len(plan.solver_faults)}")
    check(got == derived and rep.degraded_solves == derived["degraded"],
          f"ladder {got} (report degraded {rep.degraded_solves}), the CPU run's "
          f"{derived}")
    check(summary["attempts"].get("oef-noncoop/lp", 0) == derived["fallback_solves"],
          f"LP attempts {summary['attempts']}")
    check(launches == _want(ws, waterfill_solve=reached),
          f"launches {launches}, want waterfill_solve {reached} ({torch_attempts} "
          f"torch attempts less {fired} faults)")
    text = "\n".join(lines)
    stages = [p for p in ("resolve;solve", "resolve;placement") if p in text]
    check(len(stages) == 2, f"obs.report lists {stages} of the resolve stages")
    log(f"    obs.report read the run's trace and metrics back "
        f"({len(lines)} lines, both resolve stages listed)")
    detail["chaos"] = {
        "small": {k: {"n_solves": r[1].n_solves, "jobs_finished": r[1].jobs_finished,
                      "n_events": r[1].n_events, "summary": r[2],
                      "ladder": ladder(r[0])} for k, r in runs.items()},
        "small_throughput_diff": d_tp,
        "full": {"n_solves": rep.n_solves, "n_events": rep.n_events,
                 "jobs_finished": rep.jobs_finished, "wall_s": wall,
                 "summary": summary, "ladder": got,
                 "fallback_count": rep.fallback_count,
                 "degraded_solves": rep.degraded_solves, "launches": launches,
                 "resolve_latency_ms_mean": rep.resolve_latency_ms_mean,
                 "resolve_latency_ms_p95": rep.resolve_latency_ms_p95},
        "report_lines": lines[:60]}
    return launches["waterfill_solve"]


def journal_phase(np, detail, phase: int, dev="cuda") -> dict:
    """Phases 28 and 29: a replay of ``JOURNAL_CELLS[phase]`` on the torch
    tier over a trace with ``tests/test_chaos.py``'s chaos (storms and
    corrupt profiles, no solver faults: those are the process's state, not
    the trace's). The journaled run's report equals the plain run's; a run
    killed at the median of the distinct event times and resumed by
    ``resume_scheduler`` on
    ``dev`` equals the uninterrupted journaled run bit for bit; each run
    launches its fused kernel once a solve (non-coop) or once a PD segment
    (coop) and no other, and the killed and resumed halves add up to the
    whole, less the journal tail the resume re-ran. Returns the kernel's
    launches in each run."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core.torch_coop import SEG_ITERS
    from repro_torch.kernels import wrappers
    from repro_torch.service import (ChaosEngine, FaultPlan, Journal,
                                     OnlineScheduler, resume_scheduler)

    policy, n, scale, until = JOURNAL_CELLS[phase]
    coop = policy == "oef-coop"
    wrapper = "pd_segment" if coop else "waterfill_solve"
    ws = wrappers()
    plan = FaultPlan(seed=7, storms=3, storm_size=3, corrupt_profiles=3,
                     solver_faults=())
    cluster, base = service_trace(n, scale)
    trace = ChaosEngine(plan, cluster).chaos_trace(base)
    # the median of the distinct event times: over all events it would be
    # t = 0, where every tenant joins and submits its first job
    times = sorted({e.time for e in trace})
    mid = times[len(times) // 2]

    def solve_launches(solves) -> int:
        solved = [s for s in solves if not s.reused]
        return sum(s.pd_iters // SEG_ITERS for s in solved) if coop else len(solved)

    def run(jdir=None, stop=until, tracer=None):
        sched = OnlineScheduler(cluster, policy, min_resolve_interval_s=30.0,
                                solver_backend="torch", device=dev)
        journal = (Journal(jdir, snapshot_every=JOURNAL_SNAPSHOT_EVERY)
                   if jdir else None)
        _zero_launches(ws)
        if tracer is not None:
            obs.set_tracer(tracer)
        t0 = time.perf_counter()
        try:
            report = sched.run(list(trace), until=stop, journal=journal)
        finally:
            if tracer is not None:
                obs.set_tracer(None)
            if journal is not None:
                journal.close()
        return sched, report, _launches(ws), time.perf_counter() - t0

    tracer = obs.Tracer()
    with tempfile.TemporaryDirectory() as d:
        _, plain, l_plain, w_plain = run()
        s_ref, ref, l_ref, w_ref = run(os.path.join(d, "ref"), tracer=tracer)
        crash = os.path.join(d, "crash")
        s_kill, killed, l_kill, w_kill = run(crash, stop=mid)
        journal = Journal(crash, snapshot_every=JOURNAL_SNAPSHOT_EVERY)
        snaps = journal.available_snapshots()
        n_records = journal.n_recorded
        n_snap = len(journal.load_snapshot(snaps[-1])["metrics"]["solves"])
        _zero_launches(ws)
        t0 = time.perf_counter()
        resumed = resume_scheduler(crash, list(trace), until=until,
                                   snapshot_every=JOURNAL_SNAPSHOT_EVERY, device=dev)
        w_res = time.perf_counter() - t0
        l_res = _launches(ws)
    tail = solve_launches(s_kill.metrics.solves[n_snap:])
    log(f"[{phase}] {n} tenants, {policy} on torch, {len(trace)} events (chaos: 3 "
        f"storms, 3 corrupt profiles): plain {w_plain:.1f} s, journaled "
        f"{w_ref:.1f} s ({ref.n_solves} solves, {l_ref[wrapper]} {wrapper} "
        f"launches); killed at t={mid:g} s after {n_records} journaled events "
        f"({w_kill:.1f} s, {l_kill[wrapper]} launches), {len(snaps)} snapshots, "
        f"the last at {snaps[-1]} events ({n_snap} solves); resumed on {dev} in "
        f"{w_res:.1f} s ({l_res[wrapper]} launches, {tail} of them re-running "
        f"the journal tail)")
    check(set(ref.solver_backends) == {"torch"} and ref.fallback_count == 0
          and ref.degraded_solves == 0,
          f"backends {ref.solver_backends}, fallbacks {ref.fallback_count}, "
          f"degraded {ref.degraded_solves}")
    check(report_view(plain) == report_view(ref),
          "the journaled run's report differs from the plain run's")
    check(report_view(resumed) == report_view(ref),
          "the resumed run's report differs from the uninterrupted journaled run's")
    check(len(snaps) >= 2 and snaps[0] == 0, f"snapshots {snaps}")
    check(l_plain == l_ref == _want(ws, **{wrapper: solve_launches(s_ref.metrics.solves)}),
          f"launches: plain {l_plain}, journaled {l_ref}")
    check(l_kill == _want(ws, **{wrapper: solve_launches(s_kill.metrics.solves)}),
          f"the killed run's launches {l_kill}")
    check(l_res == _want(ws, **{wrapper: l_res[wrapper]})
          and l_kill[wrapper] - tail + l_res[wrapper] == l_ref[wrapper],
          f"killed {l_kill[wrapper]} - tail {tail} + resumed {l_res} != "
          f"{l_ref[wrapper]}")
    split = coop_breakdown(tracer, w_ref)
    stats = tracer.flame_stats()
    for name in ("journal/append", "journal/snapshot"):
        split[name] = sum(st["total_s"] for path, st in stats.items()
                          if path.split(";")[-1] == name)
    log(f"    journaled == plain (the journaled run traced), resumed == "
        f"uninterrupted bit for bit; {wrapper} launches {l_kill[wrapper]} - "
        f"{tail} + {l_res[wrapper]} == {l_ref[wrapper]}; the journaled run's "
        f"{w_ref:.1f} s: placement {split['placement_s']:.2f} s, solve "
        f"{split['solve_s']:.2f} s (execute {split['execute_s']:.3f} s), journal "
        f"append {split['journal/append']:.2f} s, snapshots "
        f"{split['journal/snapshot']:.2f} s")
    out = {"policy": policy, "tenants": n, "events": len(trace), "kill_at": mid,
           "traced": split,
           "n_recorded": n_records, "snapshots": len(snaps), "last_snapshot": snaps[-1],
           "n_solves": ref.n_solves, "wall_s": {"plain": w_plain, "journaled": w_ref,
                                                "killed": w_kill, "resumed": w_res},
           "launches": {"journaled": l_ref[wrapper], "killed": l_kill[wrapper],
                        "resumed": l_res[wrapper], "tail": tail}}
    detail[f"journal_{phase}"] = out
    return out["launches"]


def examples_phase(torch, np, detail, dev="cuda") -> dict:
    """Phase 46: the quickstart and online-service twins on ``dev``; returns
    the launches by wrapper of each (``quickstart``, ``online_service``)
    and the phase's numbers."""
    import io

    from repro_torch.core import torch_coop
    from repro_torch.examples import online_service, quickstart
    from repro_torch.kernels import wrappers

    ws = wrappers()
    seg = torch_coop.SEG_ITERS
    _zero_launches(ws)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        q = quickstart.main(["--device", str(dev)])
    quick_s = time.perf_counter() - t0
    q_launches = _launches(ws)
    n_noncoop = 1 + q["sp"]["solves"]
    pd_iters = q["coop"]["pd_iters"]
    check(q["sp"]["solves"] == quickstart.SP_TRIALS + 1,
          f"the SP probe solved {q['sp']['solves']} of {quickstart.SP_TRIALS + 1} instances "
          f"on the device tier")
    check(q["coop"]["backend"] == "torch" and q["coop"]["fallback_from"] is None,
          f"the coop solve came from {q['coop']['backend']} "
          f"(fallback from {q['coop']['fallback_from']})")
    for what in ("noncoop", "coop"):
        check(q[what]["max_diff"] <= PARITY,
              f"quickstart {what}: the device tier is {q[what]['max_diff']:.3e} from the LP")
    check(q["sp"]["gain"] <= PARITY, f"lying gains {q['sp']['gain']:.3e}")
    check(all(q["properties"][k] for k in ("envy_free", "sharing_incentive",
                                           "pareto_efficient")),
          f"properties {q['properties']}")
    check(pd_iters % seg == 0, f"{pd_iters} PD iterations, not whole segments of {seg}")
    want = _want(ws, waterfill_solve=n_noncoop, pd_segment=pd_iters // seg)
    check(q_launches == want, f"quickstart launches {q_launches}, want {want}")
    log(f"[46] quickstart on {dev}: {n_noncoop} non-coop solves ({q['sp']['solves']} in the "
        f"SP probe), {n_noncoop} fused water-filling launches; coop on torch, {pd_iters} PD "
        f"iterations, {pd_iters // seg} fused PD-segment launches; device tiers vs the LP "
        f"{q['noncoop']['max_diff']:.3e} / {q['coop']['max_diff']:.3e}; SP gain "
        f"{q['sp']['gain']:+.3e}; {quick_s:.2f} s")
    _zero_launches(ws)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        svc = online_service.main(["--device", str(dev)])
    svc_s = time.perf_counter() - t0
    svc_launches = _launches(ws)
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = online_service.main(["--device", "cpu"])
    rep, ref = svc["report"], cpu["report"]
    check(set(rep.solver_backends) == {"torch"} and rep.fallback_count == 0
          and rep.degraded_solves == 0,
          f"online service: backends {rep.solver_backends}, {rep.fallback_count} "
          f"fallbacks, {rep.degraded_solves} degraded")
    d_tp = same_decisions(rep, ref, "the online-service twin on the card and the CPU")
    check(rep.n_reused_solves == ref.n_reused_solves
          and rep.fairness_audits[-1] == ref.fairness_audits[-1],
          "the online-service twin's reused solves or last audit differ card to CPU")
    replay_iters = sum(s.pd_iters for s in svc["scheduler"].metrics.solves if not s.reused)
    check(svc_launches["pd_segment"] * seg >= replay_iters,
          f"{svc_launches['pd_segment']} PD-segment launches for the replay's "
          f"{replay_iters} PD iterations")
    want = _want(ws, pd_segment=svc_launches["pd_segment"])
    check(svc_launches == want, f"online-service launches {svc_launches}: only pd_segment")
    check(svc["crossval"]["max_rel_err"] < 0.01, f"cross-validation {svc['crossval']}")
    log(f"    online service on {dev}: {rep.n_solves} solves ({rep.n_reused_solves} reused), "
        f"{rep.jobs_finished} jobs, equal to the CPU's decisions (throughput diff "
        f"{d_tp:.3e}), last audit {rep.fairness_audits[-1]}; {svc_launches['pd_segment']} "
        f"fused PD-segment launches (the replay's {replay_iters // seg} segments and the "
        f"cross-validation's); cross-validation {svc['crossval']['max_rel_err']:.2e}; "
        f"{svc_s:.2f} s")
    out = {"quickstart": {"launches": q_launches, "noncoop_solves": n_noncoop,
                          "pd_iters": pd_iters, "max_diff": [q["noncoop"]["max_diff"],
                                                             q["coop"]["max_diff"]],
                          "sp_gain": q["sp"]["gain"], "seconds": quick_s},
           "online_service": {"launches": svc_launches, "n_solves": rep.n_solves,
                              "reused": rep.n_reused_solves,
                              "jobs_finished": rep.jobs_finished,
                              "replay_pd_iters": replay_iters, "throughput_diff": d_tp,
                              "crossval": svc["crossval"]["max_rel_err"], "seconds": svc_s}}
    detail["examples"] = out
    return out


def _masters(model) -> dict:
    """A host copy of every master, by name."""
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


def _master_err(got: dict, want: dict) -> float:
    """The largest |got - want| over every master, over the largest |p|
    (0 where the two are equal, which is checked first: the float32
    difference of 1.5 B masters on the host takes seconds)."""
    scale = max(float(t.abs().max()) for t in want.values())
    return max(0.0 if got[n].equal(t) else float((got[n] - t).abs().max())
               for n, t in want.items()) / scale


def mesh_phase(torch, detail, dev="cuda", cfg=None, shape=MESH_TRAIN[1:]) -> dict:
    """Phase 47: ``Trainer(mesh=)`` on a 1x1 mesh of a world-1 process group
    (NCCL on the card, gloo on the CPU) against the meshless trainer, the
    gradient compression, and the checkpoint round trip and the resize at
    ``MESH_RESIZE_LAYERS``; returns the phase's numbers. The group is
    destroyed on the way out, pass or fail."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import loss_fn
    from repro_torch.optim.compress import (compressed_psum_tree, ef_int8_compress,
                                            ef_int8_decompress, init_error_state)
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_config(MESH_TRAIN[0]) if cfg is None else cfg
    B, S = shape
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ws = wrappers()
    _zero_launches(ws)
    out = {"arch": cfg.name, "batch": B, "seq_len": S, "layers": cfg.n_layers, "marks_s": {}}
    detail["mesh"] = out
    t_phase = time.perf_counter()

    def mark(what):
        out["marks_s"][what] = time.perf_counter() - t_phase

    def peak_reset():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")

    def timed(tr) -> tuple:
        sync()
        t0 = time.perf_counter()
        loss = tr.run(1)["losses"][0]
        sync()
        return loss, time.perf_counter() - t0

    def idle_share(tr) -> float:
        sync()
        t0 = time.perf_counter()
        tr.run(1)
        sync()
        untraced = time.perf_counter() - t0
        if not cuda:
            return float("nan")
        busy = sum(k["device_ms"] for k in device_kernels(torch, lambda: tr.run(1)))
        return 1.0 - busy / 1e3 / untraced

    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=0, world_size=1)
        try:
            tcfg = TrainerConfig(seq_len=S, global_batch=B, total_steps=10, warmup=2,
                                 ckpt_dir=os.path.join(d, "ckpt"), ckpt_every=1000)
            peak_reset()
            ref = Trainer(cfg, tcfg, device=dev)
            ref_steps = [timed(ref), timed(ref)]
            mark("meshless steps")
            want = _masters(ref.state.model)
            out["meshless"] = {"losses": [x[0] for x in ref_steps],
                               "step_s": [x[1] for x in ref_steps],
                               "peak_memory_gb": peak_gb(), "idle_share": idle_share(ref)}
            del ref
            mark("meshless profiled")
            mesh = make_test_mesh((1, 1), ("data", "model"), device_type=torch.device(dev).type)
            peak_reset()
            t = Trainer(cfg, tcfg, mesh=mesh, device=dev)
            steps = [timed(t), timed(t)]
            mark("mesh steps")
            got = _masters(t.state.model)
            out["mesh"] = {"losses": [x[0] for x in steps], "step_s": [x[1] for x in steps],
                           "peak_memory_gb": peak_gb(), "idle_share": idle_share(t)}
            mark("mesh profiled")
            err = _master_err(got, want)
            out["masters_vs_meshless"] = err
            check(steps[0][0] == ref_steps[0][0],
                  f"mesh step 1 loss {steps[0][0]!r} != meshless {ref_steps[0][0]!r}")
            check(err <= MESH_MASTER_TOL, f"masters after 2 steps {err:.3e} of max |p| apart")
            # the gradients of one backward on the mesh's model, compressed
            batch = t._device_batch(next(t._data))
            model = t.state.model
            model.zero_grad(set_to_none=True)
            (loss_fn(model, batch) * t.zero.split.frac).backward()
            leaves = {k: [ps[0].grad] for k, ps in t.state.params.items()
                      if k.startswith("units/") or k == "final_norm/scale"}
            n_elems, unequal = 0, []
            for k, gs in leaves.items():
                for g in gs:
                    q, s, _ = ef_int8_compress(g, torch.zeros_like(g, dtype=torch.float32))
                    qc, sc, _ = ef_int8_compress(g.cpu(), torch.zeros(g.shape))
                    if not (torch.equal(q.cpu(), qc) and s.cpu().item() == sc.item()):
                        unequal.append((k, int((q.cpu() != qc).sum()), s.item(), sc.item()))
                    n_elems += g.numel()
            check(not unequal, f"ef_int8_compress on the card differs from the CPU's in q "
                  f"or scale (leaf, q elements, scales): {unequal[:4]}")
            reduced, _ = compressed_psum_tree(leaves, init_error_state(leaves))
            psum_eq = all(torch.equal(r, ef_int8_decompress(*ef_int8_compress(
                g, torch.zeros_like(g, dtype=torch.float32))[:2]))
                for k in leaves for r, g in zip(reduced[k], leaves[k]))
            check(psum_eq, "compressed_psum_tree over the group != ef_int8_decompress")
            model.zero_grad(set_to_none=True)
            out["compress"] = {"elements": n_elems, "tensors": sum(map(len, leaves.values()))}
            mark("compress")
            del leaves, reduced, t, model, got, want
            # the checkpoint round trip and an elastic resize to a 1-D mesh
            # from the step-1 checkpoint, at MESH_RESIZE_LAYERS; the rebuilt
            # trainer's pipeline starts over, as JAX's does, so step 2's
            # batch is its second
            cut = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, MESH_RESIZE_LAYERS))
            out["resize_layers"] = cut.n_layers
            t = Trainer(cut, dataclasses.replace(tcfg, ckpt_dir=os.path.join(d, "ckpt_cut")),
                        mesh=mesh, device=dev)
            t.run(1)
            t0 = time.perf_counter()
            t.ckpt.maybe_save(t.state_tree(), t.state.step, force=True)
            t.ckpt.wait()
            out["checkpoint_s"] = time.perf_counter() - t0
            loss2 = t.run(1)["losses"][0]
            got = _masters(t.state.model)
            mark("checkpoint")
            t0 = time.perf_counter()
            t.resize(make_test_mesh((1,), ("data",), device_type=torch.device(dev).type))
            resize_s = time.perf_counter() - t0
            check(t.state.step == 1, f"resize restored step {t.state.step}, want 1")
            next(t._data)
            again = t.run(1)["losses"][0]
            err2 = _master_err(_masters(t.state.model), got)
            check(again == loss2, f"after the resize step 2's loss {again!r} != {loss2!r}")
            check(err2 <= MESH_MASTER_TOL, f"after the resize masters {err2:.3e} apart")
            out["resize"] = {"seconds": resize_s, "loss": again, "loss_before": loss2,
                             "masters_err": err2}
            mark("resize")
            del t, got
        finally:
            dist.destroy_process_group()
    out["launches"] = _launches(ws)
    check(not any(out["launches"].values()), f"the mesh phase launched {out['launches']}")
    m, n = out["mesh"], out["meshless"]
    log(f"[47] {cfg.name} ({cfg.n_layers} layers) on a 1x1 mesh of a world-1 "
        f"{'NCCL' if cuda else 'gloo'} group, B {B} x {S}: step walls "
        f"{', '.join(f'{w:.3f}' for w in m['step_s'])} s (no mesh "
        f"{', '.join(f'{w:.3f}' for w in n['step_s'])} s), peak {m['peak_memory_gb']:.2f} GB "
        f"(no mesh {n['peak_memory_gb']:.2f}), idle {m['idle_share']:.1%} (no mesh "
        f"{n['idle_share']:.1%}); step 1 loss bit for bit, masters {err:.3e} of max |p|; "
        f"at {out['resize_layers']} layers the checkpoint written in "
        f"{out['checkpoint_s']:.1f} s, the resize to a 1-D mesh {resize_s:.1f} s, step 2 "
        f"again bit for bit (masters {err2:.3e}); int8 compression of "
        f"{n_elems / 1e6:.1f}M gradient elements card == CPU, the "
        f"{'NCCL' if cuda else 'gloo'} psum == decompress")
    log("    seconds into the phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["marks_s"].items()))
    return out


def _rglru_calls(rg) -> list:
    """The RG-LRU calls of this process so far: [forward launches, backward
    launches, forward on the TMA kernel, backward on the TMA kernel, forward
    plain versions, backward plain versions]."""
    f, b = rg.rglru_scan, rg.rglru_scan_backward
    return [f.launches, b.launches, f.launches_tma, b.launches_tma,
            rg.plain_calls[0], rg.plain_calls[1]]


def _scans(calls: list) -> list:
    """Each step's RG-LRU scans [forward, backward] from ``_rglru_calls``
    differences: kernel launches and plain-version calls alike."""
    return [[x[0] + x[4], x[1] + x[5]] for x in calls]


@contextlib.contextmanager
def _plain_counted(rg):
    """Within the context, ``rg.plain_calls`` counts the RG-LRU plain
    versions' calls [forward, backward] (on the card a call would be a
    fallback; on the CPU they stand in for the kernels)."""
    fwd, bwd = rg.rglru_scan_plain, rg.rglru_scan_backward_plain
    rg.plain_calls = [0, 0]

    def plain(*args):
        rg.plain_calls[0] += 1
        return fwd(*args)

    def plain_backward(*args):
        rg.plain_calls[1] += 1
        return bwd(*args)

    rg.rglru_scan_plain, rg.rglru_scan_backward_plain = plain, plain_backward
    try:
        yield
    finally:
        rg.rglru_scan_plain, rg.rglru_scan_backward_plain = fwd, bwd
        del rg.plain_calls


def _split_steps(torch, trainer, steps: int, cuda: bool, rg, trace: bool = True) -> dict:
    """``steps`` steps of ``trainer``, each timed to a device sync, with its
    RG-LRU calls and (on the mesh) its collectives by kind; on the card
    with ``trace`` the last one also traced for the device's busy time."""
    from repro_torch.distributed import parallel as P

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"losses": [], "step_s": [], "rglru": [], "collectives": []}
    busy = float("nan")
    for i in range(steps):
        before = _rglru_calls(rg)
        P.reset_counts()
        sync()
        t0 = time.perf_counter()
        if cuda and trace and i == steps - 1:
            holder = {}
            busy = sum(k["device_ms"] for k in device_kernels(
                torch, lambda: holder.update(trainer.run(1))))
            res = holder
        else:
            res = trainer.run(1)
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(res["losses"][0])
        out["rglru"].append([x - y for x, y in zip(_rglru_calls(rg), before)])
        out["collectives"].append({k: list(v) for k, v in P.COUNTS.items()})
    out["busy_ms"] = busy
    out["idle_share"] = 1.0 - busy / 1e3 / out["step_s"][-1]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    return out


def _split_child(rank, world, d, cfg, tcfg, dev, steps, parent) -> None:
    """One rank of phase 48: a gloo group through a ``file://`` rendezvous
    in ``d``, a (1, ``world``) mesh on ``dev``, the trainer's steps with
    every ``Block``'s input shape watched in the first, and the masters
    after the last against the meshless trainer's (``d/ref.pt``, this
    rank's blocks of them); writes ``d/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import Trainer

    _die_with_parent(parent)
    cuda = torch.device(dev).type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                            world_size=world)
    try:
        # started and joined beside the meshless runs; the card is touched
        # once they are done (``d/go``)
        while not os.path.exists(os.path.join(d, "go")):
            time.sleep(0.05)
        if cuda:
            torch.cuda.set_device(torch.device(dev).index or 0)
            rg.load()
        mesh = make_test_mesh((1, world), ("data", "model"), device_type=torch.device(dev).type)
        t = Trainer(cfg, tcfg, mesh=mesh, device=dev)
        model = t.state.model
        blocks = []
        hooks = [layer.register_forward_pre_hook(
            lambda mod, args: blocks.append(list(args[0].shape))) for layer in model.layers]
        with _plain_counted(rg):
            first = _split_steps(torch, t, 1, cuda, rg, trace=False)
            for h in hooks:
                h.remove()
            rest = _split_steps(torch, t, steps - 1, cuda, rg)
        ref = torch.load(os.path.join(d, "ref.pt"), mmap=True)
        scale = max(float(w.abs().max()) for w in ref.values())
        errs = {}
        with torch.no_grad():
            for mname, mod in model.named_modules():
                for pname, p in mod._parameters.items():
                    pl = t.zero.placed[(id(mod), pname)]
                    name = f"{mname}.{pname}" if mname else pname
                    want = ref[name][pl.index].to(p.device)
                    errs[name] = float((p.float() - want.float()).abs().max()) / scale
        err = max(errs.values())
        out = {"losses": first["losses"] + rest["losses"],
               "step_s": first["step_s"] + rest["step_s"],
               "rglru": first["rglru"] + rest["rglru"],
               "collectives": first["collectives"] + rest["collectives"],
               "idle_share": rest["idle_share"], "busy_ms": rest["busy_ms"],
               "peak_memory_gb": rest["peak_memory_gb"], "blocks": blocks,
               "masters_err": err, "coordinate": mesh.get_coordinate(),
               "worst_masters": sorted(errs.items(), key=lambda kv: -kv[1])[:6]}
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def split_phase(torch, detail, dev="cuda", cfg=None, shape=SPLIT_TRAIN[2:],
                steps=SPLIT_STEPS, world=2) -> dict:
    """Phase 48: the compute split over the ``model`` axis on one card. The
    meshless trainer runs ``steps`` steps here, and again in two
    microbatches (its own spread under a reordering of its sums), while
    ``world`` processes (``torch.multiprocessing`` spawn, this process
    having built the kernels) start and join a gloo group; then they train
    the same seed on a (1, ``world``) mesh, each on ``dev``: each step's
    loss within ``SPLIT_LOSS_TOL`` and
    the masters within ``SPLIT_MASTER_TOL`` of max |p| of the meshless
    trainer's on every rank (or within twice the reordered run's spread,
    where that is larger), every ``Block`` input a (B, S / world, d)
    block, each step's RG-LRU launches on every rank the meshless step's,
    all on the TMA kernels, and no plain-version call on the card. Returns
    the phase's numbers; the ranks are killed after ``SPLIT_TIMEOUT_S``
    or when this process fails first."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wrappers
    from repro_torch.runtime import Trainer, TrainerConfig

    arch, n_layers, _, _ = SPLIT_TRAIN
    if cfg is None:
        cfg = get_config(arch, n_layers=n_layers, remat="full", dtype="float32")
    B, S = shape
    cuda = torch.device(dev).type == "cuda"
    ws = wrappers()
    _zero_launches(ws)
    tcfg = TrainerConfig(seq_len=S, global_batch=B, total_steps=10, warmup=2)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq_len": S,
           "ranks_on_one_card": world, "dtype": cfg.dtype}
    detail["split"] = out
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    d = tempfile.mkdtemp(prefix="chip-smoke-split-")
    # the ranks start, import and join their group beside the meshless runs
    # (they wait for ``d/go`` before they touch the card)
    ctx = mp.start_processes(_split_child, args=(world, d, cfg, tcfg, dev, steps, os.getpid()),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPLIT_TIMEOUT_S
    try:
        ref = Trainer(cfg, tcfg, device=dev)
        with _plain_counted(rg):
            out["meshless"] = _split_steps(torch, ref, steps, cuda, rg)
        out["meshless"]["launches_per_step"] = _scans(out["meshless"]["rglru"])
        want = _masters(ref.state.model)
        torch.save(want, os.path.join(d, "ref.pt"))
        del ref
        # the meshless trainer against itself with its gradients summed in
        # another order (two microbatches of one row): the masters' spread
        # that reordering alone makes
        again = Trainer(dataclasses.replace(cfg, microbatches=2), tcfg, device=dev)
        again.run(steps)
        scale = max(float(w.abs().max()) for w in want.values())
        errs = {n: float((p.detach().cpu() - want[n]).abs().max()) / scale
                for n, p in again.state.model.named_parameters()}
        out["meshless_reordered"] = {"masters_err": max(errs.values()), "worst_masters": sorted(
            errs.items(), key=lambda kv: -kv[1])[:6]}
        del again, want
        if cuda:
            torch.cuda.empty_cache()
        out["meshless_s"] = time.perf_counter() - t_phase
        open(os.path.join(d, "go"), "w").close()
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"phase 48's ranks outlasted {SPLIT_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(d, ignore_errors=True)
    out["ranks"] = ranks
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = _launches(ws)
    m = out["meshless"]
    want_launches = m["launches_per_step"]
    for got in ranks:
        got["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], m["losses"]))
        got["launches_per_step"] = _scans(got["rglru"])
    log(f"[48] {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) split over model on "
        f"{world} gloo ranks sharing {dev}, B {B} x {S}: each rank's Block inputs "
        f"({B}, {S // world}, {cfg.d_model}); losses within "
        f"{max(g['loss_rel'] for g in ranks):.2e} and masters "
        f"{max(g['masters_err'] for g in ranks):.2e} of max |p| of the meshless trainer's; "
        f"RG-LRU launches a step {want_launches[-1]} on every rank")
    log(f"    meshless: step walls {', '.join(f'{w:.3f}' for w in m['step_s'])} s, idle "
        f"{m['idle_share']:.1%}, peak {m['peak_memory_gb']:.2f} GB; against itself in two "
        f"microbatches, masters {out['meshless_reordered']['masters_err']:.2e} of max |p| ("
        + ", ".join(f"{k} {v:.2e}" for k, v in out["meshless_reordered"]["worst_masters"])
        + ")")
    for r, g in enumerate(ranks):
        coll = g["collectives"][-1]
        log(f"    rank {r}: step walls {', '.join(f'{w:.3f}' for w in g['step_s'])} s, idle "
            f"{g['idle_share']:.1%}, peak {g['peak_memory_gb']:.2f} GB; collectives in the "
            f"last step: " + ", ".join(f"{k} {n} ({b / 1e9:.3f} GB)"
                                       for k, (n, b) in sorted(coll.items())))
        log("      largest master differences (of max |p|): " + ", ".join(
            f"{k} {v:.2e}" for k, v in g["worst_masters"]))
    log(f"    phase {out['seconds']:.1f} s (meshless {out['meshless_s']:.1f} s)")
    # the masters within SPLIT_MASTER_TOL, or within twice the spread that
    # reordering the meshless trainer's sums makes where that is larger (at
    # full width two AdamW steps amplify float32 reassociation past 1e-6 in
    # the table's few elements whose first moment nearly cancels)
    master_tol = max(SPLIT_MASTER_TOL, 2 * out["meshless_reordered"]["masters_err"])
    out["master_tol"] = master_tol
    for r, got in enumerate(ranks):
        check(got["loss_rel"] <= SPLIT_LOSS_TOL,
              f"rank {r}: losses {got['losses']} vs meshless {out['meshless']['losses']}")
        check(got["masters_err"] <= master_tol,
              f"rank {r}: masters {got['masters_err']:.3e} of max |p| from the meshless "
              f"ones, more than {master_tol:.3e}")
        check(got["blocks"] and all(b == [B, S // world, cfg.d_model] for b in got["blocks"]),
              f"rank {r}: Block inputs {got['blocks']}, want ({B}, {S // world}, "
              f"{cfg.d_model})")
        check(got["launches_per_step"] == want_launches,
              f"rank {r}: RG-LRU launches a step {got['launches_per_step']}, the meshless "
              f"step's {want_launches}")
        if cuda:
            check(all(x[0] == x[2] and x[1] == x[3] and x[4] == x[5] == 0 for x in got["rglru"]),
                  f"rank {r}: RG-LRU calls [fwd, bwd, fwd TMA, bwd TMA, fwd plain, bwd "
                  f"plain] a step {got['rglru']}: every call on the TMA kernels, none plain")
    if cuda:
        check(all(x[0] == x[2] and x[1] == x[3] and x[4] == x[5] == 0
                  for x in out["meshless"]["rglru"]), f"meshless RG-LRU calls "
              f"{out['meshless']['rglru']}")
        check(all(n for n in want_launches[0]), f"no RG-LRU launch: {want_launches}")
    return out


@contextlib.contextmanager
def _serve_taps(cuda: bool):
    """Within the context: each ``ops.flash_attention_gqa`` call's
    ``q_offset`` (``offsets``), the blocked path's twin's calls
    (``plain``) and each ``Attention.decode``'s output in float32
    (``attn``, in call order). On the CPU (a rehearsal) the blocked path's
    rule is widened to CPU tensors, so the flash op's plain version stands
    in for the kernel there."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL

    seen = {"offsets": [], "plain": 0, "attn": []}
    real_op, real_twin, real_decode, real_rule = (
        ops.flash_attention_gqa, TL.blocked_attention_plain, TL.Attention.decode, TL._on_kernel)

    def op(q, k, v, **kw):
        seen["offsets"].append(kw.get("q_offset", 0))
        return real_op(q, k, v, **kw)

    def twin(*args, **kw):
        seen["plain"] += 1
        return real_twin(*args, **kw)

    def decode(self, *args, **kw):
        out, cache = real_decode(self, *args, **kw)
        seen["attn"].append(out.float())
        return out, cache

    ops.flash_attention_gqa, TL.blocked_attention_plain, TL.Attention.decode = op, twin, decode
    if not cuda:
        TL._on_kernel = lambda q, k, v: not (q.requires_grad or k.requires_grad
                                             or v.requires_grad)
    try:
        yield seen
    finally:
        ops.flash_attention_gqa, TL.blocked_attention_plain, TL.Attention.decode = (
            real_op, real_twin, real_decode)
        TL._on_kernel = real_rule


def _serve_tapped(torch, model, prompts, steps: int, cuda: bool, feed=None,
                  trace: bool = False, cache_len=None) -> dict:
    """``model``'s prefill of ``prompts`` with a cache of ``cache_len``
    (default S + steps + 8, as ``generate`` sizes it) and ``steps`` decode
    steps fed ``feed`` (B, steps + 1) teacher-forced (the
    meshless tokens, as ``decode_on`` feeds them), or greedy without:
    the final-normed hidden state at every position of this rank's block,
    the logits of the prefill's last position and of every step, every
    attention layer's decode output, the tokens (each logits' argmax), the
    cache gathered whole, the flash calls (their offsets, in prefill and in
    decode), the twin's calls, the walls, the last step's collectives by
    kind and, with ``trace`` (on the card), the device's busy time in a
    profiled step after them."""
    from repro_torch.distributed import parallel as P
    from repro_torch.interop import gather_cache
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode_step, prefill

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, S = prompts.shape
    vocab = model.cfg.vocab
    out = {"logits": [], "step_s": []}
    hidden = {}
    with torch.inference_mode(), _serve_taps(cuda) as seen:
        sync()
        f0, t0 = fa.flash_attention.launches_tc, time.perf_counter()
        with prefill_hidden(model, hidden, "h"):
            cache, logits = prefill(model, {"tokens": prompts}, cache_len or S + steps + 8)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        n_pre = len(seen["offsets"])
        out["flash"] = {"prefill": n_pre, "offsets": list(seen["offsets"]),
                        "prefill_tc": fa.flash_attention.launches_tc - f0}
        toks = [torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]]
        out["logits"].append(logits)
        for i in range(steps):
            tok = toks[-1] if feed is None else feed[:, i:i + 1]
            P.reset_counts()
            sync()
            t0 = time.perf_counter()
            cache, logits = decode_step(model, cache, tok)
            sync()
            out["step_s"].append(time.perf_counter() - t0)
            out["logits"].append(logits)
            toks.append(torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None])
        out["collectives"] = {k: list(v) for k, v in P.COUNTS.items()}
        out["flash"]["decode"] = len(seen["offsets"]) - n_pre
        out["plain_blocked"] = seen["plain"]
        out["attn"] = seen["attn"]
        out["hidden"] = hidden["h"]
        out["tokens"] = torch.cat(toks, dim=1)
        out["cache"] = gather_cache(model, cache)
        if trace:
            step_cache = {**cache, "pos": cache["pos"] - 1}  # writes slot pos - 1 again
            holder = {}
            sync()
            t0 = time.perf_counter()
            busy = sum(k["device_ms"] for k in device_kernels(
                torch, lambda: holder.update(r=decode_step(model, step_cache, tok))))
            wall_s = time.perf_counter() - t0
            out.update(traced_step_s=wall_s, busy_ms=busy, idle_share=1.0 - busy / 1e3 / wall_s)
    return out


def _serve_errors(torch, got: dict, ref: dict, block) -> dict:
    """The gates of phase 49 (``rel_err``: max |diff| / max |ref|): the
    prefill's last-position logits, the hidden state at every position of
    the rank's sequence block ``block`` (a slice), every decode step's
    logits, every attention layer's decode output at every step, and the
    cache at every slot (where ``got`` ran every step of ``ref``), each the
    worst of its kind; and the steps whose
    argmax differs from the reference's tokens, each with its gap on the
    reference's logits (``gap``) against twice the two sides' largest
    difference on that row (``within``: a near-tie)."""
    dev = got["logits"][0].device
    errs = {"logits": rel_err(got["logits"][0], ref["logits"][0].to(dev)),
            "hidden": rel_err(got["hidden"], ref["hidden"][:, block].to(dev)),
            "decode_logits": max(rel_err(a, b.to(dev)) for a, b in
                                 zip(got["logits"][1:], ref["logits"][1:])),
            "decode_attention": max(rel_err(a, b.to(dev)) for a, b in
                                    zip(got["attn"], ref["attn"]))}
    if len(got["logits"]) == len(ref["logits"]):
        errs["cache"] = max(rel_err(t, ref["cache"][i][k].to(dev))
                            for i, c in enumerate(got["cache"]["layers"]) for k, t in c.items())
    flips = []
    want = ref["tokens"].to(dev)
    for i, logits in enumerate(got["logits"]):
        mine = torch.argmax(logits[:, -1], dim=-1)
        r = ref["logits"][i].to(dev)[:, -1].float()
        for b in torch.nonzero(mine != want[:, i]).flatten().tolist():
            gap = float(r[b, want[b, i]] - r[b, mine[b]])
            diff = float((logits[b, -1].float() - r[b]).abs().max())
            flips.append({"step": i, "row": b, "gap": gap, "within": gap <= 2 * diff})
    return {"errors": errs, "flips": flips}


@contextlib.contextmanager
def planted_no_global_max():
    """A planted fault for phase 49: the decode combine scales each rank's
    exponentials by its own max of the scores, never the global one."""
    import torch

    from repro_torch.distributed import parallel as P

    real = P.softmax_combine

    def combine(scores, v, group, dtype):
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = (p / P.all_reduce_(p.sum(dim=-1, keepdim=True), group)).to(dtype).float()
        out = P.all_reduce_(torch.einsum("bkgst,btkd->bskgd", probs, v.float()), group)
        B, Hkv, G, S, _ = scores.shape
        return out.reshape(B, S, Hkv * G, v.shape[-1]).to(dtype)

    P.softmax_combine = combine
    try:
        yield
    finally:
        P.softmax_combine = real


@contextlib.contextmanager
def planted_global_slot():
    """A planted fault for phase 49: a decode token's K/V written at its
    global slot index in every rank's block that has one (the owner's own
    offset ignored)."""
    from repro_torch.models import layers as TL

    real = TL.local_slot
    TL.local_slot = lambda slot, block: slot if slot < block.size else None
    try:
        yield
    finally:
        TL.local_slot = real


@contextlib.contextmanager
def planted_no_offset():
    """A planted fault for phase 49: the flash calls of the blocked path
    made without their query offset (rank 1's block attends as if it were
    the sequence's start)."""
    from repro_torch.kernels import ops

    real = ops.flash_attention_gqa
    ops.flash_attention_gqa = lambda q, k, v, **kw: real(q, k, v, **dict(kw, q_offset=0))
    try:
        yield
    finally:
        ops.flash_attention_gqa = real


MESH_SERVE_PLANTED = (("no_global_max", planted_no_global_max),
                      ("global_slot", planted_global_slot),
                      ("no_offset", planted_no_offset))


def _mesh_serve_child(rank, world, d, cfg, shape, dev, parent) -> None:
    """One rank of phase 49: a gloo group through a ``file://`` rendezvous
    in ``d``, a (1, ``world``) mesh on ``dev``, the model drawn as the
    meshless one (the same seed) and placed on it; the teacher-forced serve
    of ``_serve_tapped`` against the meshless reference ``d/ref.pt``
    (``_serve_errors``), traced, then each planted fault's; writes
    ``d/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.runtime import place_on_mesh

    _die_with_parent(parent)
    cuda = torch.device(dev).type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                            world_size=world)
    try:
        while not os.path.exists(os.path.join(d, "go")):
            time.sleep(0.05)
        if cuda:
            torch.cuda.set_device(torch.device(dev).index or 0)
            fa.load()
            torch.cuda.reset_peak_memory_stats()
        B, S, steps = shape
        t0 = time.perf_counter()
        mesh = make_test_mesh((1, world), ("data", "model"), device_type=torch.device(dev).type)
        with torch.inference_mode():
            model = place_on_mesh(init_params(cfg, torch.Generator(device=dev).manual_seed(
                MESH_SERVE_SEED)), mesh, B)
        build_s = time.perf_counter() - t0
        ref = torch.load(os.path.join(d, "ref.pt"), mmap=True)
        prompts, feed = ref["prompts"].to(dev), ref["tokens"].to(dev)
        blk = model.view.seq(S)
        block = slice(blk.start, blk.stop) if blk is not None else slice(0, S)
        got = _serve_tapped(torch, model, prompts, steps, cuda, feed=feed, trace=cuda)
        res = {k: got[k] for k in ("prefill_s", "step_s", "flash", "plain_blocked",
                                   "collectives", "traced_step_s", "busy_ms", "idle_share")
               if k in got}
        res.update(_serve_errors(torch, got, ref, block), build_s=build_s,
                   block=[block.start, block.stop], coordinate=mesh.get_coordinate())
        del got
        res["planted"] = {}
        for name, plant in MESH_SERVE_PLANTED:
            with plant():  # the reference's cache, fewer steps
                bad = _serve_tapped(torch, model, prompts, min(steps, MESH_SERVE_PLANT_STEPS),
                                    cuda, feed=feed, cache_len=S + steps + 8)
            res["planted"][name] = _serve_errors(torch, bad, ref, block)["errors"]
            del bad
        res["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                                 else float("nan"))
        torch.save(res, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_serve_phase(torch, detail, dev="cuda", cfg=None, shape=MESH_SERVE[2],
                     world=2) -> dict:
    """Phase 49: serving on a (1, ``world``) ``("data", "model")`` mesh,
    ``world`` gloo ranks sharing one card (NCCL refuses two ranks on one
    device). This process serves the model meshless (greedy, B x S prompts
    and ``steps`` decode steps; the reference) while the ranks (spawned,
    this process having built the kernels) start and join their group;
    then each rank draws the same weights, places them on the mesh
    (``runtime.place_on_mesh``: its blocks in the JAX specs, the vocab's
    too) and serves the same prompts, the decode teacher-forced on the
    reference's tokens. Gates, each at the bf16 serve gate
    ``CARD_CPU_BF16`` (float32: ``CARD_CPU_F32``) of max |reference|: the
    prefill's last-position logits, the final-normed hidden state at every
    position of each rank's sequence block, every step's logits, every
    attention layer's decode output at every step, and the KV caches
    gathered whole at every slot; a greedy token may differ only at a
    near-tie. Counts: one flash call per attention layer a prefill on each
    rank at its block's offset, all on the tensor-core kernel, none in
    decode, no call of the twin; the decode combine once an attention
    layer a step. Each planted fault of ``MESH_SERVE_PLANTED``, served with
    ``MESH_SERVE_PLANT_STEPS`` decode steps, must fail a gate. Returns the phase's numbers;
    the ranks are killed after ``MESH_SERVE_TIMEOUT_S`` or when this
    process fails first."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.models import init_params

    arch, n_layers, _ = MESH_SERVE
    if cfg is None:
        cfg = get_config(arch, n_layers=n_layers, **MESH_SERVE_CFG)
    B, S, steps = shape
    cuda = torch.device(dev).type == "cuda"
    tol = CARD_CPU_BF16 if cfg.dtype == "bfloat16" else CARD_CPU_F32
    ws = wrappers()
    _zero_launches(ws)
    n_attn = sum(k in ("full", "sliding") for k in layer_kinds_of(cfg))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "prompt_len": S,
           "decode_steps": steps, "ranks_on_one_card": world, "dtype": cfg.dtype,
           "attention": [cfg.attention_impl, cfg.attention_block_q, cfg.attention_block_kv],
           "tol": tol}
    detail["mesh_serve"] = out
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    d = tempfile.mkdtemp(prefix="chip-smoke-mesh-serve-")
    ctx = mp.start_processes(_mesh_serve_child,
                             args=(world, d, cfg, shape, dev, os.getpid()),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_SERVE_TIMEOUT_S
    try:
        with torch.inference_mode():
            model = init_params(cfg, torch.Generator(device=dev).manual_seed(MESH_SERVE_SEED))
            prompts = torch.randint(2, cfg.vocab, (B, S), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))
        ref = _serve_tapped(torch, model, prompts, steps, cuda, trace=cuda)
        out["meshless"] = {k: ref[k] for k in ("prefill_s", "step_s", "flash", "plain_blocked",
                                               "traced_step_s", "busy_ms", "idle_share")
                           if k in ref}
        out["meshless"]["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                                             else float("nan"))
        torch.save({"prompts": prompts.cpu(), "tokens": ref["tokens"].cpu(),
                    "hidden": ref["hidden"].cpu(), "attn": [a.cpu() for a in ref["attn"]],
                    "logits": [x.cpu() for x in ref["logits"]],
                    "cache": [{k: t.cpu() for k, t in c.items()}
                              for c in ref["cache"]["layers"]]}, os.path.join(d, "ref.pt"))
        del model, ref
        if cuda:
            torch.cuda.empty_cache()
        out["meshless_s"] = time.perf_counter() - t_phase
        open(os.path.join(d, "go"), "w").close()
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"phase 49's ranks outlasted {MESH_SERVE_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(d, ignore_errors=True)
    out["ranks"] = ranks
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = _launches(ws)
    out["errors"] = {g: max(r["errors"][g] for r in ranks) for g in ranks[0]["errors"]}
    out["planted"] = {name: {"errors": {g: max(r["planted"][name][g] for r in ranks)
                                        for g in ranks[0]["planted"][name]}}
                      for name, _ in MESH_SERVE_PLANTED}
    for p in out["planted"].values():
        p["failed"] = sorted(g for g, e in p["errors"].items() if e > tol)
    m = out["meshless"]
    log(f"[49] {cfg.name} ({cfg.n_layers} layers, {cfg.attention_impl} "
        f"{cfg.attention_block_q}/{cfg.attention_block_kv}, {cfg.dtype}) served on a (1, "
        f"{world}) mesh of gloo ranks sharing {dev}, B {B} x {S} + {steps} steps teacher-"
        f"forced: vs the meshless port " + ", ".join(f"{g} {e:.3e}" for g, e in
                                                  out["errors"].items())
        + f" (<= {tol:g} of max |ref|); flash calls a prefill "
        + ", ".join(f"rank {r}: {g['flash']['prefill']} at offsets "
                    f"{sorted(set(g['flash']['offsets']))} ({g['flash']['prefill_tc']} "
                    f"tensor-core), {g['flash']['decode']} in decode" for r, g in enumerate(ranks)))
    log(f"    meshless: prefill {m['prefill_s']:.3f} s, decode "
        f"{sum(m['step_s']) / len(m['step_s']):.4f} s/step, idle "
        f"{m.get('idle_share', float('nan')):.1%} (a traced step), peak "
        f"{m['peak_memory_gb']:.2f} GB")
    for r, g in enumerate(ranks):
        coll = g["collectives"]
        log(f"    rank {r} (block {g['block']}): prefill {g['prefill_s']:.3f} s, decode "
            f"{sum(g['step_s']) / len(g['step_s']):.4f} s/step, idle "
            f"{g.get('idle_share', float('nan')):.1%} (a traced step), peak "
            f"{g['peak_memory_gb']:.2f} GB; collectives a step: "
            + ", ".join(f"{k} {n} ({b / 1e9:.3f} GB)" for k, (n, b) in sorted(coll.items()))
            + f"; greedy flips {len(g['flips'])} (near-ties "
            f"{sum(f['within'] for f in g['flips'])})")
    for name, p in out["planted"].items():
        log(f"    planted fault {name!r}: " + ", ".join(f"{g} {e:.3e}" for g, e in
                                                    p["errors"].items())
            + f"; fails {p['failed'] or 'no gate'}")
    log(f"    phase {out['seconds']:.1f} s (meshless {out['meshless_s']:.1f} s)")
    check(m["flash"]["prefill"] == n_attn and m["flash"]["decode"] == 0
          and m["plain_blocked"] == 0,
          f"meshless flash calls {m['flash']}, twin calls {m['plain_blocked']}")
    for gate, err in out["errors"].items():
        check(err <= tol, f"mesh vs meshless {gate}: {err:.3e} > {tol:g}")
    for r, g in enumerate(ranks):
        want = [g["block"][0]] * n_attn
        check(g["flash"]["prefill"] == n_attn and g["flash"]["offsets"] == want
              and g["flash"]["decode"] == 0 and g["plain_blocked"] == 0,
              f"rank {r}: flash calls {g['flash']} (want {n_attn} a prefill at offset "
              f"{g['block'][0]}, none in decode), twin calls {g['plain_blocked']}")
        if cuda:
            check(g["flash"]["prefill_tc"] == n_attn,
                  f"rank {r}: {g['flash']['prefill_tc']} tensor-core launches of {n_attn}")
        check(g["collectives"].get("all_reduce_max", [0])[0] == n_attn,
              f"rank {r}: the decode combine ran {g['collectives'].get('all_reduce_max')} "
              f"times in a step, want once an attention layer ({n_attn}): the cache of "
              f"{S + steps + 8} slots must split over the ranks")
        check(all(f["within"] for f in g["flips"]),
              f"rank {r}: greedy tokens differ beyond a near-tie: {g['flips']}")
    if cuda:
        check(m["flash"]["prefill_tc"] == n_attn, f"meshless tensor-core launches {m['flash']}")
    for name, p in out["planted"].items():
        check(bool(p["failed"]), f"the planted fault {name!r} passes every gate: {p['errors']}")
    return out


#: phase 50: the traced peak of phase 47's cell against its measured peak
#: (relative), the production cell traced, and the seconds the dry-run's
#: process may take
DRYRUN_PEAK_TOL = 0.10
#: phase 50's production cells, (arch, shape) on the ``(16, 16)`` fake mesh:
#: yi-9b's training, and xlstm-350m's, whose sLSTM traces as one fake call of
#: each kernel a layer (as a position-by-position loop it had not traced)
DRYRUN_CELLS = (("yi-9b", "train_4k"), ("xlstm-350m", "train_4k"))
DRYRUN_TIMEOUT_S = 240


def _dryrun_cells(dev: str, mesh_cfg=None, split_cfg=None, serve_cfg=None) -> list:
    """Phase 50's traced cells: ``(name, cfg, ShapeCell, mesh shape,
    ranks)`` for phase 47's train cell (1x1), phase 48's train cell and
    phase 49's prefill and decode ((1, 2)), each config as its phase builds
    it unless given."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeCell

    arch, B, S = MESH_TRAIN
    mesh_cfg = mesh_cfg or get_config(arch)
    split_arch, n_layers, sB, sS = SPLIT_TRAIN
    split_cfg = split_cfg or get_config(split_arch, n_layers=n_layers, remat="full",
                                        dtype="float32")
    serve_arch, serve_layers, (vB, vS, _) = MESH_SERVE
    serve_cfg = serve_cfg or get_config(serve_arch, n_layers=serve_layers, **MESH_SERVE_CFG)
    return [("47", mesh_cfg, ShapeCell("47", "train", S, B), (1, 1), (0,)),
            ("48", split_cfg, ShapeCell("48", "train", sS, sB), (1, 2), (0, 1)),
            ("49_prefill", serve_cfg, ShapeCell("49", "prefill", vS, vB), (1, 2), (0, 1)),
            ("49_decode", serve_cfg, ShapeCell("49", "decode", vS, vB), (1, 2), (0, 1))]


def _dryrun_child(rank, d, cells, production, dev, parent) -> None:
    """Phase 50's process: each cell of ``cells`` traced at each of its
    ranks on a fake mesh of ``dev`` tensors, then each (arch, shape) of
    ``production`` through ``run_and_save`` on the ``(16, 16)`` fake mesh
    (its record also in ``chiprun_out/dryrun_torch/``); every wrapper's
    launches before and after; writes ``d/dryrun.pt``."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh

    _die_with_parent(parent)
    if torch.device(dev).type != "cuda":
        torch.set_num_threads(1)
    out = {"launches_before": launch_counts(), "cells": {}}
    for name, cfg, cell, shape, ranks in cells:
        for r in ranks:
            t0 = time.perf_counter()
            with D.fake_group(shape[0] * shape[1], r):
                mesh = make_test_mesh(shape, ("data", "model"), device_type=torch.device(dev).type)
                got = D._trace_cell(cfg, cell, mesh, D._plan(cfg, cell, mesh), rank=r,
                                    device=dev)
            got["seconds"] = time.perf_counter() - t0
            out["cells"].setdefault(name, {})[r] = got
    out["production"] = {
        f"{arch} {shape}": D.run_and_save(arch, shape, multi_pod=False, device=dev,
                                          out_dir=os.path.join(ROOT, "chiprun_out",
                                                               "dryrun_torch"))
        for arch, shape in production}
    out["launches_after"] = launch_counts()
    torch.save(out, os.path.join(d, "dryrun.pt"))


def production_check(rec) -> None:
    """Phase 50's gate on a production cell's dry-run record: ``OK``, no
    launch, and its sLSTM fake forms a step those ``step_launches`` names
    for a train cell (one a layer for a prefill or decode; none for a model
    without the sLSTM). Logs the record's numbers."""
    from repro_torch.configs import get_config

    arch, shape = rec["arch"], rec["shape"]
    if rec.get("status") == "OK":
        m, roof = rec["memory_analysis"], rec["roofline"]
        log(f"    {arch} {shape} on the {rec['mesh']} fake mesh, rank "
            f"{rec['rank']}: {rec['status']} in {rec['trace_seconds']:.1f} s; peak "
            f"{m['peak_bytes_per_device'] / 2**30:.2f} GiB a card (arguments "
            f"{m['argument_bytes_per_device'] / 2**30:.2f} GiB, fits {m['fits_hbm']}); "
            f"{rec['cost_analysis']['flops_per_device']:.4g} FLOPs, "
            f"{rec['cost_analysis']['bytes_per_device']:.4g} bytes, "
            f"{rec['collectives']['n_collectives']} collectives "
            f"({rec['collectives']['wire_bytes_per_device']:.4g} wire bytes) a card; "
            f"roofline {roof['step_time_s_max_term'] * 1e3:.1f} ms ({roof['bottleneck']}), "
            f"useful FLOPs {roof['useful_flops_ratio']:.3f}; fake forms "
            f"{rec['kernels']['fake_calls']}")
    check(rec.get("status") == "OK", f"the production cell {arch} {shape}: {rec.get('error')}")
    cfg = get_config(arch)
    if rec["kind"] == "train":
        want = {k: n * max(1, cfg.microbatches) for k, n in step_launches(cfg).items()}
    else:
        want = {"slstm_scan": slstm_layers(cfg)[1]}
    fake = rec["kernels"]["fake_calls"]
    check(all(fake[k] == want.get(k, 0) for k in ("slstm_scan", "slstm_scan_backward"))
          and not rec["kernels"]["launches"],
          f"{arch} {shape}: sLSTM fake forms {fake}, want {want}; launches "
          f"{rec['kernels']['launches']}")


def dryrun_phase(torch, detail, mesh_t, split_t, serve_t, dev="cuda", cells=None,
                 production=DRYRUN_CELLS) -> dict:
    """Phase 50: the dry-run of phases 47-49's cells and of one production
    cell, traced on fake ``dev`` tensors in a spawned process (its fake
    process group must not meet those phases' groups), held to what those
    phases measured (``mesh_t``, ``split_t``, ``serve_t``): (a) phase 47's
    traced peak within ``DRYRUN_PEAK_TOL`` of its measured peak; (b) the
    traced collectives of phase 48's train step and phase 49's decode step
    at each rank those of its real last step, calls and input bytes by
    kind; (c) the fake-form calls a step at each rank phase 48's RG-LRU
    launches (forward, backward) and phase 49's flash calls a prefill, and
    no launch in the dry-run's process or this one; (d) each production
    cell's record ``OK``, its sLSTM fake forms a step those ``step_launches``
    names (none for a model without the sLSTM). Returns the phase's
    numbers."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.kernels import wrappers
    from repro_torch.launch.dryrun import roofline

    cells = _dryrun_cells(dev) if cells is None else cells
    production = production or ()
    ws = wrappers()
    before = _launches(ws)
    out = {"cells": {}, "production_cells": [list(c) for c in production], "production": {}}
    detail["dryrun"] = out
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    ctx = mp.start_processes(_dryrun_child, args=(d, cells, production, dev, os.getpid()),
                             nprocs=1, join=False, start_method="spawn")
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"phase 50's process outlasted {DRYRUN_TIMEOUT_S} s")
        got = torch.load(os.path.join(d, "dryrun.pt"), weights_only=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(d, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = {k: got["launches_after"][k] - got["launches_before"][k]
                       for k in got["launches_after"]}
    out["launches_here"] = {k: v - before[k] for k, v in _launches(ws).items()}
    for name, by_rank in got["cells"].items():
        out["cells"][name] = {r: {k: t[k] for k in (
            "argument_bytes", "peak_bytes", "flops", "bytes", "counts", "result_bytes",
            "fake_calls", "launches", "seconds")} for r, t in by_rank.items()}
    cell = out["cells"]
    # (a) phase 47's peak, and the roofline step beside the measured one
    traced = cell["47"][0]
    measured = mesh_t["mesh"]["peak_memory_gb"] * 1e9
    out["peak_rel_err"] = abs(traced["peak_bytes"] - measured) / measured
    out["roofline_47"] = roofline(traced["flops"], traced["bytes"], 0.0)
    log(f"[50] the dry-run (repro_torch.launch.dryrun) on fake {dev} tensors in a process of "
        f"its own, {out['seconds']:.1f} s: phase 47's {MESH_TRAIN[0]} B {MESH_TRAIN[1]} x "
        f"{MESH_TRAIN[2]} on a 1x1 fake mesh traced in {traced['seconds']:.1f} s: peak "
        f"{traced['peak_bytes'] / 1e9:.3f} GB (arguments {traced['argument_bytes'] / 1e9:.3f} "
        f"GB) against the measured {measured / 1e9:.3f} GB ({out['peak_rel_err']:.2%}); "
        f"roofline step {out['roofline_47']['step_time_s_max_term'] * 1e3:.1f} ms "
        f"({out['roofline_47']['bottleneck']}; compute "
        f"{out['roofline_47']['compute_s'] * 1e3:.1f} ms, memory "
        f"{out['roofline_47']['memory_s'] * 1e3:.1f} ms) against the measured "
        + ", ".join(f"{s * 1e3:.1f}" for s in mesh_t["mesh"]["step_s"]) + " ms")
    check(out["peak_rel_err"] <= DRYRUN_PEAK_TOL,
          f"phase 47's traced peak {traced['peak_bytes'] / 1e9:.3f} GB is "
          f"{out['peak_rel_err']:.2%} from the measured {measured / 1e9:.3f} GB")
    # (b), (c) phases 48 and 49 at each rank
    for r, real in enumerate(split_t["ranks"]):
        t = cell["48"][r]
        fwd_bwd = real["rglru"][-1][:2]
        log(f"    phase 48, rank {r} ({t['seconds']:.1f} s): collectives "
            + ", ".join(f"{k} {n} ({b / 1e9:.3f} GB)" for k, (n, b) in sorted(t["counts"].items()))
            + f"; RG-LRU fake forms {t['fake_calls']['rglru_scan']} forward, "
            f"{t['fake_calls']['rglru_scan_backward']} backward (launches a step {fwd_bwd})")
        check(t["counts"] == real["collectives"][-1],
              f"phase 48 rank {r}: traced collectives {t['counts']}, the real step's "
              f"{real['collectives'][-1]}")
        check([t["fake_calls"]["rglru_scan"], t["fake_calls"]["rglru_scan_backward"]]
              == fwd_bwd and fwd_bwd[0] > 0,
              f"phase 48 rank {r}: RG-LRU fake forms {t['fake_calls']}, launches {fwd_bwd}")
    for r, real in enumerate(serve_t["ranks"]):
        pre, dec = cell["49_prefill"][r], cell["49_decode"][r]
        log(f"    phase 49, rank {r} ({pre['seconds']:.1f} + {dec['seconds']:.1f} s): flash "
            f"fake forms a prefill {pre['fake_calls']['flash_attention']} (calls "
            f"{real['flash']['prefill']}); decode collectives "
            + ", ".join(f"{k} {n} ({b / 1e9:.3f} GB)" for k, (n, b) in sorted(dec["counts"].items())))
        check(dec["counts"] == real["collectives"],
              f"phase 49 rank {r}: traced decode collectives {dec['counts']}, the real "
              f"step's {real['collectives']}")
        check(pre["fake_calls"]["flash_attention"] == real["flash"]["prefill"] > 0
              and dec["fake_calls"]["flash_attention"] == real["flash"]["decode"],
              f"phase 49 rank {r}: flash fake forms {pre['fake_calls']} / {dec['fake_calls']}, "
              f"calls {real['flash']}")
    check(not any(out["launches"].values()) and not any(out["launches_here"].values())
          and not any(t["launches"] for by_rank in cell.values() for t in by_rank.values()),
          f"the dry-run launched kernels: {out['launches']}, here {out['launches_here']}")
    # (d) the production cells
    for arch, shape in production:
        rec = got["production"][f"{arch} {shape}"]
        res = out["production"][f"{arch} {shape}"] = {k: rec.get(k) for k in (
            "status", "error", "trace_seconds", "memory_analysis", "cost_analysis", "roofline",
            "attn_mode", "n_chips", "kernels")}
        res["collectives"] = {k: rec.get("collectives", {}).get(k) for k in (
            "wire_bytes_per_device", "n_collectives")}
        production_check(rec)
    return out


def progress(msg: str) -> None:
    """A line on stderr with the clock time: where a run that is stopped got
    to shows at the end of its errors."""
    print(f"chip_smoke {time.strftime('%H:%M:%S')}: {msg}", file=sys.stderr, flush=True)


def _die_with_parent(parent: int) -> None:
    """In a process this script started: exits when ``parent`` is gone (a
    stopped run leaves no process behind)."""
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def service_phase(torch, np, wf, ev, detail) -> dict:
    """Phase 4: the online service at full size; returns the fused solve's
    launches and ``waterfill_masses``'s (which must be 0)."""
    from repro_torch import obs
    from repro_torch.core import torch_solve

    torch_solve.prewarm(1024, 3, device="cuda")
    record = []
    others = (wf.waterfill_masses, ev.envy_gaps, ev.pd_segment)
    for w in (wf.waterfill_solve, *others):
        w.launches = 0
    sched, report, wall = service_replay(1024, 128, "torch", "cuda", 1200.0,
                                         record=record)
    launches = wf.waterfill_solve.launches
    other_launches = [w.launches for w in others]
    masses_launches = other_launches[0]
    check(not any(other_launches), f"the non-coop replay launched waterfill_masses, "
          f"envy_gaps, pd_segment {other_launches} times")
    solved = [s for s in sched.metrics.solves if not s.reused]
    warm = sum(1 for s in solved if s.warm_started)
    expected = len(solved)
    anomalies = report.anomalies
    log(f"[4] 1024 tenants / 3072 devices, until 1200 s: {report.n_solves} solves "
        f"({len(solved)} solved, {warm} warm), {report.n_events} events, "
        f"{report.jobs_finished} jobs finished, wall {wall:.1f} s, "
        f"{launches} fused-solve launches (want {expected}, one a solve)")
    check(set(report.solver_backends) == {"torch"},
          f"solver_backends {report.solver_backends}")
    check(report.fallback_count == 0, f"fallback_count {report.fallback_count}")
    check(report.degraded_solves == 0, f"degraded_solves {report.degraded_solves}")
    check("solver_floor" not in anomalies, f"anomalies {anomalies}")
    check(len(solved) >= 30, f"only {len(solved)} non-reused solves")
    check(launches == expected, f"{launches} launches, want {expected}")
    check(all(np.isfinite(list(report.steady_state_estimate.values()))),
          "non-finite throughput estimate")
    worst = instances_agree(record, np)
    lat = [s.latency_s * 1e3 for s in solved]
    solve_share = sum(s.latency_s for s in sched.metrics.solves) / wall
    log(f"    resolve_latency_ms mean {report.resolve_latency_ms_mean:.3f} "
        f"p95 {report.resolve_latency_ms_p95:.3f} (all solves); non-reused mean "
        f"{float(np.mean(lat)):.3f} p95 {percentile(lat, 95, np):.3f}; "
        f"solver share of wall {solve_share:.3f}; {len(record)} instances "
        f"agree with CPU and numpy (largest difference {worst:.3e})")
    tracer = obs.Tracer()
    _, report2, wall2 = service_replay(1024, 128, "torch", "cuda", 1200.0,
                                       tracer=tracer)
    check(decision_fields(report) == decision_fields(report2),
          "second full-size replay differs from the first")
    stats = tracer.flame_stats()
    top = sorted(stats.items(), key=lambda kv: -kv[1]["total_s"])[:12]
    solve_s = sum(st["total_s"] for path, st in stats.items()
                  if path.endswith(";resolve;solve"))
    log(f"    second replay identical (wall {wall2:.1f} s, traced; resolve;solve "
        f"{solve_s:.3f} s, {solve_s / wall2:.2%} of wall); the unfused solve "
        f"before the fused kernel: resolve_latency_ms mean 5.2-8.1, p95 8.7-13.8")
    detail["service_1024"] = {
        "n_solves": report.n_solves, "solved": len(solved), "warm": warm,
        "n_events": report.n_events, "jobs_finished": report.jobs_finished,
        "wall_s": wall, "traced_wall_s": wall2, "launches": launches,
        "resolve_latency_ms_mean": report.resolve_latency_ms_mean,
        "resolve_latency_ms_p95": report.resolve_latency_ms_p95,
        "solved_latency_ms_mean": float(np.mean(lat)),
        "solved_latency_ms_p95": percentile(lat, 95, np),
        "solver_share_of_wall": solve_share, "max_diff": worst,
        "traced_solve_share_of_wall": solve_s / wall2,
        "flame_top": {p: s for p, s in top}}

    return {"launches": launches, "masses_launches": masses_launches}


def service_128_phase(np, detail) -> None:
    """Phase 5: 128 tenants: numpy, torch on the card, torch on the CPU."""
    reports = {}
    record = []
    for label, backend, device, rec in (("numpy", "numpy", "cuda", None),
                                        ("cuda", "torch", "cuda", record),
                                        ("cpu", "torch", "cpu", None)):
        _, rep, w = service_replay(128, 16, backend, device, 7200.0, record=rec)
        reports[label] = rep
        log(f"[5] 128 tenants / 384 devices, {label:5s}: {rep.n_solves} solves, "
            f"{rep.jobs_finished} jobs, {rep.n_events} events, wall {w:.1f} s, "
            f"backends {rep.solver_backends}")
    a, b = reports["cpu"], reports["cuda"]
    check(set(b.solver_backends) == {"torch"} and b.fallback_count == 0,
          f"card replay backends {b.solver_backends}")
    d_tp = same_decisions(a, b, "card and CPU torch replays")
    c = reports["numpy"]
    for what, x, y in (("solves", c.n_solves, b.n_solves),
                       ("jobs finished", c.jobs_finished, b.jobs_finished),
                       ("events", c.n_events, b.n_events),
                       ("total throughput", sum(c.tenant_throughput.values()),
                        sum(b.tenant_throughput.values()))):
        check(abs(x - y) <= NUMPY_REL * max(abs(y), 1.0),
              f"numpy replay's {what} {x} vs the card's {y}: more than "
              f"{NUMPY_REL:.0%} apart")
    worst5 = instances_agree(record, np)
    log(f"    card == CPU replay (throughput diff {d_tp:.3e}), numpy replay "
        f"within {NUMPY_REL:.0%}; {len(record)} "
        f"instances agree with CPU and numpy (largest difference {worst5:.3e})")
    detail["service_128"] = {
        k: {"n_solves": r.n_solves, "jobs_finished": r.jobs_finished,
            "n_events": r.n_events} for k, r in reports.items()}
    detail["service_128"]["max_diff"] = worst5


#: the seconds from its start that main waits for the scheduler lane
LANE_TIMEOUT_S = 900


def scheduler_lane(d: str, parent: int) -> None:
    """The scheduler lane: phases 4, 5, 7-9 and 27-29 (the online service's
    replays, host-bound: the card sees a solve now and then), in a process
    of its own that runs beside the model phases. Its log goes to
    ``d/log.txt``, its numbers to ``d/result.pkl``, a failure's traceback to
    ``d/error.txt``."""
    import pickle
    import traceback

    _die_with_parent(parent)
    sys.stdout = open(os.path.join(d, "log.txt"), "w", buffering=1)
    try:
        import numpy as np
        import torch

        from repro_torch.kernels import envy as ev
        from repro_torch.kernels import waterfill as wf

        wf.load()
        ev.load()
        detail, phase_s, mark = {}, {}, [time.perf_counter()]

        def lap(phase) -> None:
            now = time.perf_counter()
            phase_s[phase] = now - mark[0]
            mark[0] = now
            progress(f"phase {phase} done in the scheduler lane")

        out = service_phase(torch, np, wf, ev, detail)
        lap(4)
        service_128_phase(np, detail)
        lap(5)
        coop_tier_phase(np, ev, detail)
        lap(7)
        out["segment_launches"], out["envy_launches"] = coop_service_phase(
            torch, np, ev, wf, detail)
        lap(8)
        coop_devices_phase(detail)
        lap(9)
        out["chaos_launches"] = chaos_phase(np, detail)
        lap(27)
        out["journal"] = {}
        for phase in (28, 29):
            out["journal"][phase] = journal_phase(np, detail, phase)
            lap(phase)
        out.update(detail=detail, phase_s=phase_s)
        with open(os.path.join(d, "result.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(d, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        sys.stdout.flush()


class SchedulerLane:
    """Starts :func:`scheduler_lane` in a spawned process (daemonic: it ends
    with this one); :meth:`join` prints its log and returns its numbers, and
    fails where it failed or outlasted ``LANE_TIMEOUT_S``."""

    def __init__(self):
        import atexit
        import multiprocessing
        import shutil
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-lane-")
        atexit.register(shutil.rmtree, self.dir, True)
        self.t0 = time.monotonic()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=scheduler_lane, args=(self.dir, os.getpid()), daemon=True)
        self.proc.start()

    def join(self) -> dict:
        import pickle

        self.proc.join(max(0.0, self.t0 + LANE_TIMEOUT_S - time.monotonic()))
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)
            raise SmokeFailure(f"the scheduler lane outlasted {LANE_TIMEOUT_S} s")
        with open(os.path.join(self.dir, "log.txt")) as f:
            print(f.read(), end="", flush=True)
        err = os.path.join(self.dir, "error.txt")
        if os.path.exists(err):
            with open(err) as f:
                raise SmokeFailure("the scheduler lane failed:\n" + f.read())
        check(self.proc.exitcode == 0, f"the scheduler lane exited {self.proc.exitcode}")
        with open(os.path.join(self.dir, "result.pkl"), "rb") as f:
            return pickle.load(f)


#: the CPU threads a deferred CPU half (:class:`Behind`) computes with: the
#: card phase beside it and the scheduler lane each want a core of their own
BEHIND_THREADS = 6


class Behind:
    """The CPU half of a card-against-CPU phase (work on host tensors only)
    on a thread of its own, beside the card phases that follow it: one at a
    time (:meth:`submit` first drains the one before). :meth:`drain` waits
    for it and raises what it raised (a failed check)."""

    def __init__(self, torch):
        self.torch, self.job, self.err = torch, None, None

    def submit(self, fn) -> None:
        import threading

        self.drain()
        torch = self.torch

        def run():
            try:
                torch.set_num_threads(min(BEHIND_THREADS, torch.get_num_threads()))
                fn()
            except BaseException as e:  # raised again by drain
                self.err = e

        self.job = threading.Thread(target=run, name="chip-smoke-cpu-half")
        self.job.start()

    def drain(self) -> None:
        if self.job is not None:
            self.job.join()
            self.job = None
        if self.err is not None:
            err, self.err = self.err, None
            raise err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.core import oef, torch_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels import envy as ev
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import slstm as sl
    from repro_torch.kernels import waterfill as wf
    from repro_torch.kernels import xent as xe

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    detail = {"card": smi, "torch": torch.__version__}
    t_all = time.perf_counter()
    clock, mark = {}, [t_all]

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)

    def note(group, now=None) -> None:
        """Adds ``group``'s seconds by phase to ``clock`` and writes it to
        ``chiprun_out/chip_smoke_phase_s.json``, so a run that fails still
        tells where its time went."""
        now = time.perf_counter() if now is None else now
        for phase, sec in group.items():
            clock[phase] = clock.get(phase, 0.0) + sec
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_phase_s.json"), "w") as f:
            json.dump({"phase_s": clock, "elapsed_s": now - t_all}, f)

    def lap(phase=None, group=None) -> None:
        """This process's seconds since the last lap, to ``phase`` (a phase
        met again adds to its seconds), or a group's own per-phase seconds
        (``group``); each lap also says on stderr how far the run is."""
        now = time.perf_counter()
        note(group if group is not None else {phase: now - mark[0]}, now)
        mark[0] = now
        progress(f"{now - t_all:.0f} s in, phase {phase if group is None else sorted(group)} "
                 f"done")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernel_mods = (wf, ev, rg, fa, xe, sl)
    with ThreadPoolExecutor(max_workers=len(kernel_mods)) as pool:
        lib_paths = list(pool.map(_build.build, ("waterfill", "envy", "rglru_scan",
                                                 "flash_attention", "xent", "slstm")))
    for mod in kernel_mods:
        mod.load()
    build_s = time.perf_counter() - t0
    log(f"[1] built {', '.join(os.path.relpath(p, ROOT) for p in lib_paths)} "
        f"in {build_s:.2f} s")
    for lib_path in lib_paths:
        for line in _build.BUILD_LOG.get(lib_path, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    detail["build_s"] = build_s
    lap(1)
    # the fused solver kernels must not spill: their state is meant to stay
    # in registers and shared memory
    fused_ptxas = {}
    for lib, kernel in (("waterfill", "waterfill_solve_kernel"), ("envy", "pd_segment_kernel")):
        for fn, rep in kernel_report(lib).items():
            if kernel in fn and "registers" in rep:
                fused_ptxas[kernel_name(fn)] = rep
                check("0 bytes spill stores, 0 bytes spill loads" in rep.get("spills", ""),
                      f"{fn} spills: {rep}")
    check(len(fused_ptxas) == 3 or not any(_build.BUILD_LOG.values()),
          f"ptxas reported {sorted(fused_ptxas)}, want the two waterfill_solve_kernel "
          f"instances and pd_segment_kernel")
    for fn, rep in fused_ptxas.items():
        log(f"    {fn}: {rep['registers']}; {rep['spills']}")
    detail["fused_ptxas"] = fused_ptxas

    # -- 2. kernel vs plain version ---------------------------------------------
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = 0
    for n_pad in (8, 128, 1024, 8192):
        for k in (3, 4):
            W, m = staircase(rng, n_pad - n_pad // 4, k, np)
            _, Wf, m64, mask = torch_solve._prepare(W, m)
            check(Wf.shape[0] == n_pad, f"bucket of {W.shape[0]} is {Wf.shape[0]}")
            hi = float((Wf * mask[:, None]).max(axis=0) @ m64 / mask.sum()) + 1.0
            for T in (1, 8):
                taus = hi * np.arange(1, T + 1) / (T + 1.0)
                ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                       for a in (taus, Wf, m64, mask)]
                got = wf.waterfill_masses(*ops)
                ref = wf.waterfill_masses_plain(*(o[None] for o in ops))[0]
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)
                max_err = max(max_err, float((got - ref).abs().max()))
                cases += 1
    log(f"[2] kernel == plain on {cases} cases (atol=rtol={TOL:g}), "
        f"max |diff| {max_err:.3e}")
    n_pad, k, T = 1024, 3, 8
    W, m = staircase(np.random.default_rng(1), n_pad, k, np)
    _, Wf, m64, mask = torch_solve._prepare(W, m)
    hi = float((Wf * mask[:, None]).max(axis=0) @ m64 / mask.sum()) + 1.0
    ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (hi * np.arange(1, T + 1) / (T + 1.0), Wf, m64, mask)]
    batched = [o[None] for o in ops]
    kernel_ms = graph_ms(torch, lambda: wf._launch(*batched))
    plain_ms = graph_ms(torch, lambda: wf.waterfill_masses_plain(*batched))
    kernel_call_ms = call_ms(torch, lambda: wf.waterfill_masses(*ops))
    n_bytes = (n_pad * k + n_pad + k + 2 * T) * 8
    n_ops = T * n_pad * k * 8
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"    n_pad={n_pad} k={k} T={T}: kernel {kernel_ms * 1e3:.2f} us "
        f"(graph replay; {kernel_call_ms * 1e3:.2f} us per wrapper call), "
        f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e6:.2f} ns "
        f"({bound_by})")
    lap(2)
    detail["kernel"] = {"cases": cases, "max_abs_err": max_err,
                        "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bytes": n_bytes, "fp64_ops": n_ops}

    # -- 3. the fused solve ---------------------------------------------------
    solve_t = solve_phase(torch, np, wf, detail)
    lap(3)

    # -- 6. the envy-gap kernel and the fused PD segment ------------------------
    envy_t = envy_phase(torch, np, ev, detail)
    segment_t = segment_phase(torch, np, ev, detail)
    lap(6)

    # -- 10, 13-15. the RG-LRU, attention and cross-entropy kernels, timed
    # before another process shares the card --------------------------------------
    rg_t = rglru_phase(torch, rg, detail)
    lap(10)
    fa_t = flash_phase(torch, fa, detail)
    lap(13)
    xe_t = xent_phase(torch, xe, detail)
    lap(14)
    rgb_t = rglru_backward_phase(torch, rg, detail)
    lap(15)

    # -- 4, 5, 7-9, 27-29. the online service's replays, in a process of their
    # own beside phases 11-25 ---------------------------------------------------------
    main_threads = torch.get_num_threads()
    lane = SchedulerLane()
    torch.set_num_threads(max(1, main_threads - 1))
    behind = Behind(torch)

    # -- 51. the sLSTM kernels: beside the lane, whose solves take the card
    # now and then (its ~30-40 s on the main path before the lane started
    # put the script past ~1,000 s on a slow host) ----------------------------------
    sl_t = slstm_phase(torch, sl, detail)
    lap(51)

    # -- 11-12, 16-17. serving and training recurrentgemma-2b --------------------
    rg_launches = serve_phase(torch, rg, detail, rg_t)
    lap(11)
    rg_tma = detail[f"serve_{ARCH}"]["launches_tma"]
    devices_phase(torch, rg, detail)
    lap(12)
    train = train_phase(torch, rg, detail)
    lap(16)
    train_devices_phase(torch, rg, detail, S=TRAIN_CUT_S[ARCH], behind=behind)
    lap(17)

    # -- 18-25. qwen2-1.5b, gemma3-4b and xlstm-350m: the CPU half of each
    # training step card against CPU (17, 21, 25) runs beside the card phase
    # after it ---------------------------------------------------------------------
    from repro_torch.configs import get_config

    for arch, _, _ in DENSE:
        serve_phase(torch, rg, detail, rg_t, 18, arch)
    lap(18)
    behind.drain()
    lap(17)
    for arch, n_layers, S in DENSE:
        devices_phase(torch, rg, detail, 19, arch, n_layers, S)
    lap(19)
    for arch, _, _ in DENSE:
        train_phase(torch, rg, detail, 20, arch)
    lap(20)
    (qwen, qwen_layers, qwen_s), (gemma, gemma_layers, gemma_s) = DENSE
    train_devices_phase(torch, rg, detail, 21, qwen, qwen_layers,
                        TRAIN_CUT_S.get(qwen, qwen_s), behind=behind)
    lap(21)
    arch, n_layers, S = XLSTM
    serve_phase(torch, rg, detail, rg_t, 22, arch)
    lap(22)
    train_devices_phase(torch, rg, detail, 21, gemma, gemma_layers,
                        TRAIN_CUT_S.get(gemma, gemma_s), behind=behind)
    lap(21)
    xl_train = train_phase(torch, rg, detail, 24, arch,
                           cfg=get_config(arch, logits_chunk=512))
    lap(24)
    behind.drain()
    lap(21)
    devices_phase(torch, rg, detail, 23, arch, n_layers, S)
    lap(23)
    train_devices_phase(torch, rg, detail, 25, arch, n_layers, S, behind=behind)
    lap(25)
    t_wait = time.perf_counter()
    lane_t = lane.join()
    mark[0] = time.perf_counter()  # the wait is no phase's
    detail["lane_wait_s"] = mark[0] - t_wait
    torch.set_num_threads(main_threads)
    note(lane_t["phase_s"])
    detail.update(lane_t["detail"])
    launches, masses_launches = lane_t["launches"], lane_t["masses_launches"]
    segment_launches, envy_launches = lane_t["segment_launches"], lane_t["envy_launches"]
    chaos_launches, journal_t = lane_t["chaos_launches"], lane_t["journal"]

    # -- 26. scheduled training ------------------------------------------------------
    sched_t = sched_train_phase(torch, np, detail)
    lap(26)
    behind.drain()
    lap(25)

    # -- 30-33. yi-9b, phi4-mini, phi-3-vision and the blocked path ------------
    blocked_t = blocked_phases(torch, rg, detail, rg_t, behind=behind)
    lap(group=blocked_t["phase_s"])

    # -- 34-37. whisper-tiny: the encoder, cross-attention, sinusoids ---------
    whisper_t = whisper_phases(torch, rg, detail, rg_t)
    lap(group=whisper_t["phase_s"])

    # -- 38-41. arctic-480b and kimi-k2-1t-a32b: the MoE layer ------------------
    moe_t = moe_phases(torch, rg, detail, rg_t)
    lap(group=moe_t["phase_s"])

    # -- 42-45. training arctic-480b and kimi-k2-1t-a32b -------------------------
    moe_train_t = moe_train_phases(torch, detail)
    lap(group=moe_train_t["phase_s"])

    # -- 46-47. the example twins, and the mesh on one card -----------------------
    examples_t = examples_phase(torch, np, detail)
    lap(46)
    mesh_t = mesh_phase(torch, detail)
    lap(47)

    # -- 48. the compute split over the model axis, two ranks on one card ---------
    split_t = split_phase(torch, detail)
    lap(48)

    # -- 49. serving on a mesh, the KV cache split, two ranks on one card ----------
    mesh_serve_t = mesh_serve_phase(torch, detail)
    lap(49)

    # -- 50. the dry-run: phases 47-49's cells and a production cell traced ----
    dryrun_t = dryrun_phase(torch, detail, mesh_t, split_t, mesh_serve_t)
    lap(50)
    detail["total_s"] = time.perf_counter() - t_all
    detail["phase_s"] = clock

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, sort_keys=True)
    log("seconds by phase: " + ", ".join(f"{p}: {v:.1f}" for p, v in sorted(clock.items())))
    log(f"    phases {', '.join(map(str, sorted(lane_t['phase_s'])))} ran in the scheduler "
        f"lane beside 11-25 ({sum(lane_t['phase_s'].values()):.1f} s; main waited "
        f"{detail['lane_wait_s']:.1f} s at its join); the CPU halves of 17, 21, 25 and 33 "
        f"beside the card phases after them (their own seconds in their log lines)")
    log(f"total {detail['total_s']:.1f} s")
    kernels = [{
        "name": "waterfill_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:49",
        "launches": launches,
        "max_abs_err": solve_t["max_abs_err"],
        "ms": solve_t["kernel_ms"],
        "plain_ms": solve_t["plain_ms"],
        "bound_ms": solve_t["bound_ms"],
        "bound_by": solve_t["bound_by"],
        "library_ms": solve_t["library_ms"],
        "launches_in": "phase 4 (the count above), phase 27 (chaos at full size), "
                       "phase 29 (the journaled non-coop replay, uninterrupted)",
        "launches_by_phase": {"4": launches, "27": chaos_launches,
                              "29": journal_t[29]},
    }, {
        "name": "waterfill_masses",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:49",
        "launches": masses_launches,
        "launches_in": "phase 4, where waterfill_solve runs in its place",
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "pd_segment",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/envy.cu",
        "replaces": "src/repro/kernels/envy.py:38",
        "launches": segment_launches,
        "max_abs_err": segment_t["max_abs_err"],
        "ms": segment_t["kernel_ms"],
        "plain_ms": segment_t["plain_ms"],
        "bound_ms": segment_t["bound_ms"],
        "bound_by": segment_t["bound_by"],
        "library_ms": segment_t["library_ms"],
        "launches_in": "phase 8 (the count above), phase 28 (the journaled coop "
                       "replay, uninterrupted)",
        "launches_by_phase": {"8": segment_launches, "28": journal_t[28]},
    }, {
        "name": "envy_gaps",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/envy.cu",
        "replaces": "src/repro/kernels/envy.py:38",
        "launches": envy_launches,
        "launches_in": "phase 8, where pd_segment runs in its place",
        "max_abs_err": envy_t["max_abs_err"],
        "ms": envy_t["kernel_ms"],
        "plain_ms": envy_t["plain_ms"],
        "bound_ms": envy_t["bound_ms"],
        "bound_by": envy_t["bound_by"],
        "library_ms": envy_t["library_ms"],
    }, {
        "name": "rglru_scan_tma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:22",
        "launches": rg_launches,
        "max_abs_err": rg_t["max_abs_err"],
        "ms": rg_t["kernel_ms"],
        "plain_ms": rg_t["plain_ms"],
        "bound_ms": rg_t["bound_ms"],
        "bound_by": rg_t["bound_by"],
        "library_ms": rg_t["library_ms"],
        "launches_train": train["launches_tma"][0],
        "launches_in": "phase 11 (the count above), phase 16 (launches_train), "
                       "phase 26 (recurrentgemma-2b as a scheduled tenant)",
        "launches_by_phase": {"11": rg_launches, "16": train["launches_tma"][0],
                              "26": sched_t["rglru_scan_tma"]},
        "train_shape_ms": rg_t["shapes"]["train_fp32"]["tma"]["kernel_ms"],
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:22",
        "launches": rg_launches - rg_tma,
        "launches_in": "phase 10: the direct route, for operands TMA cannot take; "
                       "the serve and train paths take the TMA kernel",
        "launches_by_phase": {"26": sched_t["rglru_scan"] - sched_t["rglru_scan_tma"]},
        "max_abs_err": rg_t["max_abs_err"],
        "ms": rg_t["direct_ms"],
        "plain_ms": rg_t["plain_ms"],
        "bound_ms": rg_t["bound_ms"],
        "bound_by": rg_t["bound_by"],
        "library_ms": rg_t["library_ms"],
        "train_shape_ms": rg_t["shapes"]["train_fp32"]["direct"]["kernel_ms"],
    }, {
        "name": "rglru_scan_backward_tma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:22",
        "replaces_note": "the backward of that scan, which the JAX model takes by "
                         "differentiating rglru_scan_ref (src/repro/models/layers.py:770)",
        "launches": train["launches_tma"][1],
        "launches_in": "phase 16 (the count above), phase 26 (recurrentgemma-2b "
                       "as a scheduled tenant)",
        "launches_by_phase": {"16": train["launches_tma"][1],
                              "26": sched_t["rglru_scan_backward_tma"]},
        "max_abs_err": rgb_t["max_abs_err"],
        "ms": rgb_t["kernel_ms"],
        "plain_ms": rgb_t["plain_ms"],
        "bound_ms": rgb_t["bound_ms"],
        "bound_by": rgb_t["bound_by"],
        "library_ms": rgb_t["library_ms"],
    }, {
        "name": "rglru_scan_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:22",
        "replaces_note": "the backward of that scan, which the JAX model takes by "
                         "differentiating rglru_scan_ref (src/repro/models/layers.py:770)",
        "launches": train["launches"][1] - train["launches_tma"][1],
        "launches_in": "phase 15: the direct route, for operands TMA cannot take; "
                       "the train path takes the TMA kernel",
        "launches_by_phase": {"26": sched_t["rglru_scan_backward"]
                              - sched_t["rglru_scan_backward_tma"]},
        "max_abs_err": rgb_t["max_abs_err"],
        "ms": rgb_t["direct_ms"],
        "plain_ms": rgb_t["plain_ms"],
        "bound_ms": rgb_t["bound_ms"],
        "bound_by": rgb_t["bound_by"],
        "library_ms": rgb_t["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": blocked_t["flash"]["yi-9b"],
        "launches_in": "phase 30: the count above is one yi-9b prefill on the blocked "
                       "path (one launch a layer; launches_tc of them on the tensor-core "
                       "kernel); phase 13 held the op to its plain version at the shapes "
                       "of phase 30's yi-9b and gemma3-4b prefills and phase 38's "
                       "arctic-480b prefill (max_abs_err: the "
                       "worst full-width shape) and timed it at yi-9b's (ms, plain_ms, "
                       "bound_ms, library_ms)",
        "launches_by_phase": {"13": fa_t["launches"], "30": blocked_t["flash"],
                              "38": {ARCTIC: moe_t["flash"]}},
        "launches_38_note": "38: one arctic-480b blocked prefill; the phase runs three "
                            "on flash (38-41 counts them) and one on the twin (no launch)",
        "launches_tc_38": moe_t["flash_tc"],
        "launches_tc": blocked_t["flash_tc"]["yi-9b"],
        "shape": list(FLASH_FULL[0][1:]),
        "max_abs_err": fa_t["max_abs_err"],
        "max_abs_err_cases": fa_t["max_abs_err_cases"],
        "ms": fa_t["kernel_ms"],
        "plain_ms": fa_t["plain_ms"],
        "bound_ms": fa_t["bound_ms"],
        "bound_by": fa_t["bound_by"],
        "library_ms": fa_t["library_ms"],
        "fp32_ms": fa_t["fp32_ms"],
        "at_an_offset": {label: {k: t[k] for k in (
            "q_offset", "shape", "window", "max_abs_err_bfloat16", "max_abs_err_float32",
            "kernel_ms", "tflops", "fp32_kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for label, t in fa_t["offset"].items()},
        "launches_49": {"meshless": mesh_serve_t["meshless"]["flash"],
                        "ranks": [r["flash"] for r in mesh_serve_t["ranks"]]},
    }, {
        "name": "softmax_xent",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xent.cu",
        "replaces": "src/repro/kernels/xent.py:28",
        "launches": xe_t["launches"],
        "max_abs_err": xe_t["max_abs_err"],
        "ms": xe_t["kernel_ms"],
        "plain_ms": xe_t["plain_ms"],
        "bound_ms": xe_t["bound_ms"],
        "bound_by": xe_t["bound_by"],
        "library_ms": xe_t["library_ms"],
    }]
    # the sLSTM kernels replace no Pallas kernel: the JAX model's lax.scan
    xl_serve = detail["serve_xlstm-350m"]
    for wrapper, way, count, by_phase in (
            ("slstm_scan", "forward",
             xl_serve["kernel_launches"]["slstm_scan"]
             + xl_serve["decode_kernel_launches"]["slstm_scan"],
             {"22": {"prefill": xl_serve["kernel_launches"]["slstm_scan"],
                     "decode": xl_serve["decode_kernel_launches"]["slstm_scan"]},
              "24": sum(p[0] for p in xl_train["slstm_launches_per_step"])}),
            ("slstm_scan_backward", "backward",
             sum(p[1] for p in xl_train["slstm_launches_per_step"]),
             {"24": sum(p[1] for p in xl_train["slstm_launches_per_step"])})):
        t = sl_t[way]
        kernels.append({
            "name": wrapper,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slstm.cu",
            "replaces": "src/repro/models/layers.py:699",
            "replaces_note": "no Pallas kernel: the jax.lax.scan of slstm_apply (:699) and "
                             "the step of slstm_decode (:725), which XLA runs as one loop "
                             "on the device" + ("; its backward, which JAX takes by "
                                                "differentiating the scan" if way == "backward"
                                                else ""),
            "launches": count,
            "launches_in": ("phase 22 (the served model's prefill and 32 decode steps at "
                            "full depth)" if way == "forward" else
                            "phase 24 (3 train steps at full depth)"),
            "launches_by_phase": dict(by_phase, **{"26": sched_t[wrapper]}),
            "max_abs_err": sl_t["max_abs_err" if way == "forward" else "backward_max_abs_err"],
            "rel_err_by_case": {label: c[way]["rel_err"] for label, c in sl_t["cases"].items()},
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "plain_graph_ms": t["plain_graph_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": sl_t["shape"],
            "us_per_step": {label: tt[way]["us_per_step"] for label, tt in sl_t["times"].items()},
            "ms_by_case": {label: tt[way]["kernel_ms"] for label, tt in sl_t["times"].items()},
            "bound_ms_by_case": {label: tt[way]["bound_ms"]
                                 for label, tt in sl_t["times"].items()},
            "route_by_case": {label: tt["route"] for label, tt in sl_t["times"].items()},
        })
    # whisper-tiny's phases launch no kernel, the MoE phases only the blocked
    # prefill's flash, MoE training none: each entry records its wrapper's
    # count there (the TMA and direct routes share one wrapper)
    for k in kernels:
        wrapper = k["name"].replace("_tma", "")
        k.setdefault("launches_by_phase", {})["34-37"] = whisper_t["launches"][wrapper]
        k["launches_by_phase"]["38-41"] = moe_t["launches"][wrapper]
        k["launches_by_phase"]["42-45"] = moe_train_t["launches"][wrapper]
        k["launches_by_phase"]["46"] = {
            twin: examples_t[twin]["launches"][wrapper]
            for twin in ("quickstart", "online_service")}
        k["launches_by_phase"]["47"] = mesh_t["launches"][wrapper]
        k["launches_by_phase"]["48"] = split_t["launches"][wrapper]
        # phase 49: this process's count (the meshless serve's), each rank's
        # in the flash entry's ``launches_49``
        k["launches_by_phase"]["49"] = mesh_serve_t["launches"][wrapper]
        # phase 50: the dry-run's process launches nothing; its fake forms
        # are counted below, apart
        k["launches_by_phase"]["50"] = dryrun_t["launches"][wrapper]
    # phase 48 counts the RG-LRU launches of each step by route, the meshless
    # trainer's here and each rank's in a process of its own: those of its
    # two steps (``_rglru_calls``: forward, backward, their TMA routes)
    of_route = {"rglru_scan_tma": lambda x: x[2], "rglru_scan": lambda x: x[0] - x[2],
                "rglru_scan_backward_tma": lambda x: x[3],
                "rglru_scan_backward": lambda x: x[1] - x[3]}
    for k in kernels:
        count = of_route.get(k["name"])
        if count is not None:
            k["launches_by_phase"]["48"] = {
                "meshless": sum(map(count, split_t["meshless"]["rglru"])),
                "ranks": [sum(map(count, r["rglru"])) for r in split_t["ranks"]]}
    # the fake forms the dry-run called (phase 50), by cell and rank, a step
    fake_of = {"flash_attention": "flash_attention", "rglru_scan_tma": "rglru_scan",
               "rglru_scan_backward_tma": "rglru_scan_backward", "slstm_scan": "slstm_scan",
               "slstm_scan_backward": "slstm_scan_backward"}
    for k in kernels:
        form = fake_of.get(k["name"])
        if form is not None:
            k["fake_calls_50"] = {
                name: [t["fake_calls"][form] for _, t in sorted(by_rank.items())]
                for name, by_rank in dryrun_t["cells"].items()}
            for cell, rec in dryrun_t["production"].items():
                k["fake_calls_50"][cell] = rec["kernels"]["fake_calls"][form]
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
