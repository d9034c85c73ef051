#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (src/repro_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives KLARAPTOR's tune -> choose -> launch loop on the card for each of
the port's six CUDA kernels, serves llama3.2-1b (16 layers, d_model 2048,
32 q and 8 kv heads of dim 64, d_ff 8192, vocab 128256, bf16, seeded random
weights), mamba2-130m, qwen3-moe-235b (full width, 4 of 94 layers) and the
six other architectures that fit one card through the port's prefill step
and serving engine (its steps as CUDA graphs), derives kernel specs from
the compiled kernels, runs the budgeted online search on the card, and
serves with the search escalation, the telemetry loop and a tracer
installed, farms the tier-1 builds, a kill drill and a ledger-fed retune
out to spawned workers taking turns on the card, watches the serving
side through the observatory, trains llama3.2-1b at full width through
the hand-written flash-attention backward kernel, and mamba2-130m,
qwen3-moe (1 layer), internlm2-1.8b, whisper-medium and grok-1 (1 layer)
through it and the SSD scan's and the grouped matmul's backward kernels,
and gemma2-2b through the flash backward with its softcap, window and
head dim 256 (every train step updating its parameters and AdamW moments
in place), and drives ``distributed/`` (the mesh, data-parallel training,
the collectives, GPipe, the elastic restore) over NCCL and
``examples/serve_lm.py``, one phase per printed block:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc compiles every CUDA source of the port (timed), with each
     kernel's registers and spills against its cap (every wgmma tile and
     the f32 SIMT mainloop of the matmul and the grouped matmul with no
     spill), and the HGMMA (wgmma) instructions in each library's SASS
     (``cuobjdump -sass``): the matmul, the grouped matmul and flash
     attention must have some;
  3. the kernel against its plain PyTorch version on the card: every
     compiled bf16 wgmma tile with each output type (f32, bf16, f16) at k
     1024 (the 4-slot ring wraps), every feasible f32 SIMT tile at k 1024
     (the 3-slot cp.async ring wraps) and at k = bk (one k step), f32 in
     with bf16 and f16 out, and both at the five GEMM shapes;
  4. KLARAPTOR on the card: probes of the real kernel (CUDA events) at
     m, n, k <= 1024, the SVD fit and the generated driver;
  5. the tuned launch through ``ops.matmul`` at the five shapes, with kernel
     time, TFLOP/s and % of bound, ``torch.matmul`` (yardstick only),
     default-config and plain times, and the launch counter;
  6. the selection ratio against exhaustive search at three shapes
     (printed, not gated);
  7. the flash-attention kernel against its plain version, bf16 and f32,
     causal and not, GQA group 4 and 1, window 64, softcap 30, head dims
     64 / 128 / 256, at a ragged length, over every compiled wgmma tile
     (bf16, d 64 / 128 / 256) and every feasible SIMT tile (f32);
  8. KLARAPTOR on the card for ``flash_attn_d64_causal``: probes at
     bh <= 64 and sq = skv <= 1024, the fit, the choice at the prefill shape
     (bh 32, sq = skv = 4096) and, after phase 9, its selection ratio against
     exhaustive search (printed, not gated);
  9. the prefill step of llama3.2-1b at full width on 4096 tokens (cut from
     the ``prefill_32k`` preset's 32 x 32768 to fit the time limit): the
     tuned flash kernel launches once per layer, the logits are held against
     the same step with the plain attention, and each layer's attention is
     timed (kernel with TFLOP/s and % of bound, default tile, bound, SDPA
     yardstick, plain), then summed per prefill beside the profile's flash
     share of the prefill's device time;
 10. the serving engine at full width: 4 slots, 8 requests, every request
     finishes, and each greedy request's first token is compared with the
     argmax of the prefill step on its prompt;
 11. the SSD chunked-scan kernel against its plain version, bf16 and f32,
     (head dim, state) (64, 128) and the smoke model's (32, 32), with B and
     C per head (h = 1) and shared by 24 rows (h = 24), at a ragged length
     and at 4096, dt in the JAX kernel tests' range and small (where the
     carried state dominates), over every compiled or feasible chunk;
 12. KLARAPTOR on the card for ``ssd_scan_h64_n128``: probes at bh <= 64 and
     s <= 2048, the fit, the choice at the prefill shape (bh 24, s 4096)
     and, after phase 13, its selection ratio against exhaustive search over
     the feasible chunks (printed, not gated);
 13. the prefill step of mamba2-130m at full width (24 layers, d_model 768,
     24 SSM heads of dim 64, state 128, vocab 50280, bf16, seeded random
     weights) on 4096 tokens (cut from ``prefill_32k`` as llama's is): the
     tuned SSD kernel launches once per layer, the logits are held against
     the same step with the plain SSD, and each layer's SSD is timed
     (kernel with % of bound and CTAs, default chunk, both bounds -- B and
     C read once per group, as the kernel reads them, and once per head, as
     the reference's interface hands them over -- plain);
 14. the serving engine at full width: 4 slots, 8 requests, every request
     finishes; the first request of a separate batch-1 engine has its first
     token compared with the prefill step's argmax (the JAX engine, which
     the port reproduces, leaks recurrent state between slots and requests,
     so that is the one request where the two must agree).

 15. the grouped-matmul kernel against its plain version, bf16 (every
     compiled wgmma tile) and f32 (every feasible SIMT tile, each also at
     k = bk), at a small shape whose k steps wrap the rings, and at an
     unaligned shape through ``ops.moe_gmm`` (zero-padded);
 16. KLARAPTOR on the card for ``moe_gmm_b16``: probes at e <= 4 and g, k,
     n <= 1024, the fit, then tuned launches through ``ops.moe_gmm`` at
     qwen3-moe-235b's expert width (d_model 4096, expert d_ff 1536) with 8
     local experts of 4096 tokens each, the up (k 4096 -> n 1536) and the
     down (k 1536 -> n 4096) product; each held against the plain version,
     timed (TFLOP/s, % of bound) against ``torch.bmm`` (yardstick only) and
     the bound, and the selection ratio against exhaustive search (printed,
     not gated); then KLARAPTOR on ``moe_gmm_b32`` (the same probes) and a
     tuned f32 launch through ``ops.moe_gmm`` at the up product, timed
     against ``torch.bmm`` in f32 (TF32 off) and the FP32 bound, and its
     selection ratio against one exhaustive pass on the card (printed, not
     gated; phase 25 searches on the same pass);
 17. introspection on the card: ``layernorm_c2048_b16`` (llama3.2-1b's
     d_model) and ``colsum_b16`` derived from the compiled kernels (grid,
     operands with their dependences, constraints, compiled registers
     against the launch-bounds cap, spilled bytes); ``matmul_b16`` and
     ``moe_gmm_b16`` derived likewise, and drivers built from them choose
     the configs the hand specs' drivers choose (``HopperModel`` oracle, the
     reference's equivalence shapes);
 18. the auto path: ``build_auto_kernels(d_model=2048)`` tuned against the
     card; the layernorm's fit errors, its probe rows, and per br candidate
     at each probe and chosen-for size the card's time (with and without
     the timer's L2 flush) beside the driver's prediction; then ``ops.layernorm`` at r 4096, 16384 and 4097 (a ragged
     last
     row block, which must still launch many CTAs) and
     ``ops.blocked_colsum`` at (8192, 4096) and (2048, 8192), each held
     against its plain version, timed against the bytes bound and one
     PyTorch call (``F.layer_norm``, which leaves out the residual add;
     ``torch.sum``), the column sum's workspace bytes and two calls on one
     input held to identical bits, and the selection ratios against
     exhaustive search;
 19. the entry point: ``repro_torch.launch.serve.main`` with
     ``--auto-kernels`` in this process (the drivers dropped and the driver
     cache pointed at an empty directory first, so it tunes both kernels on
     the card again), serving llama3.2-1b requests;
 20. the paper's evaluation on the card: (a) the quickstart's loop on
     ``matmul_b16`` (nine wgmma tiles, N 1024-16384) into an empty driver
     cache, then a fresh ``python`` process that must find the driver there:
     ``from_cache``, no probe launch (the matmul counter unchanged while it
     builds and chooses) and the first process's choices at every N; (b)
     the PolyBench suite's nine matmul rows that launch the f32 SIMT matmul:
     one spec, ``matmul_b32``, so one build and one driver on the card
     (``CudaEventTimer``), with Fig. 1 at N 2048 and Table I at N 1024 and
     2048 -- the card's exhaustive best, the chosen config and the ratio,
     from one exhaustive pass per N, each beside the driver's predicted
     time and the rank each side gives the other's pick; the f32 matmul at
     N 2048
     with the chosen tile against its plain version, ``torch.matmul`` in f32
     (TF32 off) and the FP32 bound; (c) Fig. 3 for gemm, measured: the
     build's wall seconds and those of the exhaustive pass over N 32-2048,
     beside the reference's modeled formula; (d) the suite's other 19 rows on
     ``HopperModel`` at the card's parameters, labelled so.  The ratios are
     printed, not gated; the cache read and "every card row ran on
     ``CudaEventTimer``" are gated;
 21. KLARAPTOR's launch plans on the card: (a) ``precompile_plans`` into an
     empty driver cache for ``matmul_b16``, ``flash_attn_d64_causal`` and
     ``ssd_scan_h64_n128``, from the drivers phases 4, 8 and 12 built, over
     envelopes that hold the GEMM shapes of phase 5 and the prefill shapes
     of phases 9 and 13 (every plan entry must be the driver's ``choose``
     at that shape), then ``ops.matmul`` at two GEMM shapes decided by the
     plan; (b) a fresh ``python`` process warm-starts from that cache: the
     drivers and plans load with no kernel launched, the plans equal (a)'s,
     and its first tuned flash launch is decided by the plan; a third
     process, from a copy of the cache whose flash plan claims other kernel
     code, must not install that plan; (c) / (d) the llama3.2-1b and
     mamba2-130m prefills of phases 9 and 13 under a step plan built from
     ``decode_kernel_requests``: 16 flash / 24 SSD launches, the registry
     untouched (``stats()``, the decision memo), logits bit-identical to the
     same step resolved through the registry; (e) the host microseconds of
     one decision at llama's prefill shape (decision memo, the chain behind
     it with the memo off, which a plan serves, plan probe, step plan,
     driver ``choose``, default, a bare dict probe), beside the tuned
     flash launch's card time from phase 9 (printed, not gated);
 22. qwen3-moe-235b-a22b at the full width of its config (d_model 4096, 64
     q / 4 kv heads of dim 128, qk-norm, 128 experts, top-8, expert d_ff
     1536, vocab 151936, bf16, seeded random weights), cut to 4 of its 94
     layers: phase 16's ``moe_gmm_b16`` driver read back through the driver
     cache given its spec, and a driver for ``flash_attn_d128_causal``
     built on the card as phase 8 builds head dim 64's; (a) the prefill
     step at B 1 x S 4096 (each call launches flash exactly 4 and the
     grouped matmul exactly 12 times; warm wall time; the profile's device
     time by group: grouped matmul, flash, cuBLAS, sort and top-k, gather
     and scatter, the rest); (b) its logits within 5e-2 x max |logit| of
     the same step with plain flash and the plain grouped matmul, and per
     layer the share of (token, slot) expert choices the two runs share;
     (d) the engine of phase 10 (every request finishes; ms per
     decode-step call beside the bound of reading every weight but the
     embedding once; the grouped-matmul launches, 12 per call); (c) after
     the path's counters are read, layer 0's launches at their shapes --
     the grouped matmul's prefill gate/up (e 128, g 320, 4096 -> 1536) and
     down (1536 -> 4096) and the same at decode (g 8, padded to 64): the
     tuned tile with its CTAs, ``ops.moe_gmm``, the default tile,
     ``torch.bmm``, the plain version, the bound and the selection ratio
     (printed, not gated); flash at bh 64 (GQA 64 / 4), d 128 against SDPA
     and its bound; the router's f32 product;
 23. the rest of the serving engine: (a) llama3.2-1b and mamba2-130m at
     full width and phase 22's qwen3-moe (4 layers), 4 slots, max_seq 256:
     a few requests, then 20 decode calls through the engine's graphed
     step and 20 of the eager ``model.decode_step`` on the same inputs
     (ms per call, the profile's device-busy share of both, qwen3-moe's
     weight-read bound beside), one decode capture per engine (gated) and
     the graphed logits against the eager step's on the same cache
     (gated at 5e-2 x max |logit|, the difference printed); (b) bucketed
     dispatch: ``ops.matmul(in_graph=)`` over 34 raw bf16 shapes with a
     plan from phase 4's driver read back through the driver cache, and
     causal flash, the layernorm and the column sum at 4 raw shapes each,
     one CUDA graph per branch over padded buffers (gated: captures <=
     branches, each sliced output against its plain version at the kernel
     tests' bf16 tolerance, ``host_index`` = ``branch_index`` on the card
     for every shape, each bucket's config = the driver's ``choose``);
     (c) one llama3.2-1b engine (batch 4, max_seq 96, chunk 32): first a
     64-token prompt and three others (every capture; their seconds, of
     them recording, printed), then 32 prompt lengths, 2 new tokens each,
     greedy, through the async front-end, the synchronous loop, and the
     async front-end prefilling through the decode graph once per prompt
     token (gated: the same tokens, ``compile_counts`` {decode_step 1,
     prefill_chunk <= 6}; tok/s, async / sync beside the JAX bench's 1.5
     and the chunk graphs' gain printed), then one 64-token prompt warm
     and right after a re-plan (an override pinned: every step re-captured,
     gated, and the stall printed); (d) qwen3-moe's engine with ``default_plan_envelope``
     and ``default_bucket_lattices``: warm start, plan summary and the step
     plan's entries printed, the registry's counters and memo unchanged
     over 16 decode calls and one re-capture after a pinned override
     (gated); then one JSON line ``{"engine": ...}``.  Every engine of
     phases 10, 14, 22 and 23 runs its steps as CUDA graphs and prints its
     ``compile_counts`` and each capture's seconds and pool growth;
 24. the remaining architectures that fit the card, at the full width of
     their configs with seeded random weights, every stacked matrix
     rescaled to std 1 / sqrt(fan-in) (the reference's init takes the
     stack's depth as the fan-in, which makes attention near one-hot and
     two correct bf16 steps drift apart with depth): grok-1-314b (2 of 64
     layers, MoE 8 experts top-2, softcaps 30), qwen3-14b (qk-norm),
     internlm2-1.8b, gemma2-2b (head dim 256 on the flash kernel's wgmma
     body, 4096-token windows on every other layer, softcap 50),
     internvl2-76b (16 of 80 layers; 256 patch embeddings before the
     tokens) and whisper-medium (the encoder over 1500 frame embeddings,
     then the decoder over 448 tokens, cross-attending); jamba-1.5-large
     does not fit one card.  First a ``flash_attn_d256_causal`` driver is
     built on the card, written through the driver cache and read back
     from it.  Per architecture: (a) the prefill step (B 1, S 4096; gemma2
     8192; the launches of flash attention and the grouped matmul gated
     exactly; warm wall ms and the profile's device-busy share); (b) the
     engine (4 slots, max_seq 256, 4 requests; every request finishes, one
     decode capture) and ms per graphed decode call, with its device ms,
     beside the weight-read bound; (c) after the counters are read, the
     eager decode step on the cache of one graphed call (graphed logits
     bit-equal to it; gated), the prefill's logits within 5e-2 x max
     |logit| of the same step with the plain attention and the plain
     grouped matmul and grok-1's and gemma2's within their final softcap
     (gated), then each distinct attention launch of the prefill at its
     shape and with the tiles the path launched there (gemma2's local and
     global layers, whisper's encoder, decoder self and cross attention)
     against default / SDPA (where one SDPA call computes the same
     function: no window, no softcap) / plain / bound, and grok-1's
     grouped matmul at its prefill and decode shapes against ``torch.bmm``,
     the plain version on the first rows of each expert, and the bound
     (gated: the op times the tiles the path launched); the peak memory is
     printed.  Then the d 256 driver's selection ratio
     at gemma2's shape, and one JSON line ``{"archs": ...}``;
 25. KLARAPTOR's budgeted online search (``search.run_search``) on the
     card, every probe timed by ``CudaEventTimer`` (a warm-up launch, an
     L2 flush and a ~100 us spin before each timed one): (a) for the f32
     SIMT matmul at N 2048 (one exhaustive pass before the path's
     counters start, its summed medians the exhaustive device-seconds)
     and the f32 grouped matmul at phase 16's up product (phase 16's
     pass), each of ``random``, ``lhs``,
     ``successive_halving`` and ``surrogate`` under 25 % of those
     device-seconds, and ``random`` under ``default_budget``: the chosen
     tile, its ratio against the pass's best, executions, accounted
     device-seconds and their fraction, wall seconds and wall over
     device-seconds, and the rows probed but cut after the probe (gated:
     no run over its executions or device-seconds, every run finds a
     feasible tile; the 0.85 bar printed only); (b) four builds of
     ``matmul_b32``, one per strategy, into an empty driver cache, with
     probe executions, device-seconds and the Fig. 1 ratio at N 2048
     against (a)'s pass (gated: halving probes fewer distinct tiles at
     every later probe size than at its first, each build misses the
     cache, a repeat of the first hits it); then one JSON line
     ``{"search": ...}``;
 26. the observed serving path: (a) ``choose_or_default``'s search
     escalation on ``matmul_b32`` at N 2048 from an empty cache and
     registry (``spec=`` and ``device=CudaEventTimer``, a budget of 25 %
     of phase 25's pass): a feasible tile and its ratio against that pass
     (the 0.85 bar printed), a repeat served by the memo with no probe, a
     halved budget searching again and ``spec=`` alone probing nothing
     (counted by a wrapping oracle; gated), then
     ``ServingEngine.tune_for_shape`` for ``flash_attn_d64_causal`` at
     llama3.2-1b's prefill shape past a matmul driver registered under
     its name (a ``{bq, bkv}`` tile, gated); (b) the telemetry loop over
     ``CudaEventTimer`` with a ``matmul_b32`` driver fitted on
     ``HopperModel`` at three times the card's memory rate and peaks
     under the card's name: decisions at N 2048 until a refit runs (gated:
     one drift, the refit within its executions and device-seconds, the
     driver swapped, a fresh registry's warm start at ``tuning_version``
     1; the drift's EWMA, probe and refit device-seconds and wall, and
     the swapped driver's and the served tile's ratios against phase
     25's pass printed beside the 0.90 bar); then a ``StepGraph`` over
     ``ops.matmul`` with the loop installed: the capture's decision
     queues its probe, which runs after the capture (gated, with the
     replay bit-equal to the eager call); (c) llama3.2-1b at full width,
     phase 10's slots and requests, served plainly and with ``trace=`` a
     ``Tracer`` and ``telemetry=`` the loop over the model's kernel specs
     and ``CudaEventTimer`` (a ledger in a temporary file): greedy tokens
     bit-equal and the same captures (gated), every probe queued during a
     capture run after it (gated), decisions by source, shadow probes,
     re-captures, spans by name, graphed decode ms per call without a
     tracer, with one and with the phase's, which writes each span to the
     ledger (six rounds each on the observed engine, the order reversed
     every other round), and the Chrome trace and the ledger read back;
     then
     one JSON line ``{"observed": ...}``;
 27. the tuning farm and the observatory: (a) first one process builds
     the four tier-1 drivers (``matmul_b16``, ``flash_attn_d128_causal``,
     ``moe_gmm_b16``, ``ssd_scan_h64_n128``) at the probe settings of
     phases 4, 8, 12 and 16 and collects ``matmul_b32`` (comparisons);
     then ``FleetCoordinator.tune(tier1_spec_refs())`` on
     ``CudaEventTimer`` with two spawned process workers that take turns
     on the card through its lock (gated: every job completes, the merged
     rows equal one process's, and so do their times: the per-row
     ratio's median and the device-seconds within 10 %; each farm driver
     lands under the key ``Klaraptor.build_driver`` computes, the
     workers' held lock intervals (one per row) never overlap; the
     farm's and one process's wall, device-seconds,
     requeues, dropped duplicates, and each driver's choice at the shapes
     of phases 5, 9, 13 and 16 beside one process's, with the card ms of
     both, printed); (b) the same tune of ``matmul_b32`` with worker 0
     killed at its first job (gated: the lease requeued, the worker
     respawned, the rows equal one process's; the recovery time and the
     longest gap between two heartbeats printed); (c) phase 26 (b)'s
     drifting driver served with a ledger, the telemetry loop's refit
     left to the farm: ``RetuneQueue.ingest`` of the ledger, then
     ``FleetCoordinator.retune`` with two process workers under 25 % of
     phase 25's pass (gated: the key done, the versioned cache at the
     next ``tuning_version``, the serving registry untouched until a warm
     start, which reads that version; the served tile's ratio printed);
     (d) an ``Observatory`` over (c)'s serving side with
     ``default_rules()`` (gated: ``evaluate()``, a non-empty ``snapshot()``
     and ``prometheus()``, a scorecard row for ``matmul_b32``, the
     ledger's ``replay_ledgers`` equal to the live bus; alerts and the
     keys a breach boosted printed), then ``python -m
     repro_torch.launch.status --ledger`` and ``python -m
     repro_torch.launch.fleet status --spool`` (exit 0); then one JSON
     line ``{"fleet": ...}``.  Every ``kernels`` row carries
     ``fleet_path_launches``: the launches the workers' kept results
     report plus this process's shadow probes in (c);
 28. training on the card: (a) the flash-attention backward kernel
     (``csrc/flash_attention_bwd.cu``) against its plain version at
     llama3.2-1b's training shape (bh 256 = B 8 x 32 heads, S 256) and
     prefill shape (bh 32, S 4096), GQA 32 / 8, d 64, causal, bf16 (gated:
     dq, dk, dv each within 2e-2 x max |plain|; the forward's output
     bit-equal with and without lse), each timed beside the bound (2.5 x
     the forward's FLOPs), the plain version, SDPA's backward and the
     forward with and without lse, the kernels' registers and spills; (b)
     ``TrainLoop`` on llama3.2-1b at full width (16 layers, bf16, remat
     "full", weights at std 1 / sqrt(fan-in)), B 8 x S 256 from
     ``SyntheticStream``, 10 steps, keep 1, one async save at step 6 and
     the loop's final one: first the step-1 gradient against the same step
     with autograd through ``flash_attention_plain`` (gated: every leaf
     finite and non-zero, each within 5e-2 x max |g|, the loss within
     1e-2), then the loop (gated: finite losses; the flash forward and
     backward launched), its ms per step, tokens/s, peak memory, losses
     and gradient norms, flash launches per step, the saves' seconds, one
     step's profile by kernel group (the optimizer's kernels those under
     the step's ``adamw_update`` range; gated: some); (c) a crash
     at step 5 and a resume from step 4's checkpoint at 2 layers, full
     width, against an uninterrupted run (gated: parameters and moments
     bit-equal), and ``ops.matmul`` / ``ops.layernorm`` on card inputs
     that require grad (gated: they raise, having no backward yet); then
     one JSON line ``{"train": ...}``.  The ``kernels`` line gains the
     backward kernel's row (its launches on the training path) and the
     flash row ``train_path_launches``.
 29. training beyond llama on the card: (a) the SSD scan's backward
     (``csrc/ssd_scan_bwd.cu``: bf16 on the wgmma body, f32 on the SIMT
     body) against ``ssd_scan_backward_plain`` at mamba2-130m's training
     shape (bh 192 = B 8 x 24 heads sharing one group's B and C, S 256, dh
     64, n 128, bf16 and f32) and prefill shape (bh 24, S 4096), at the
     chunk ``ops.ssd_scan`` resolves with grad on, each bf16 call timed
     beside the SIMT body at the same shape,
     and the grouped matmul's backward (``csrc/moe_gmm.cu``, dX and dW on
     wgmma with the transposed operand read in place) against
     ``moe_gmm_backward_plain`` at qwen3-moe's training shapes (the
     gate / up and down products of one layer at B 8 x S 256, 128 experts
     of 160 rows padded to 192, bf16; the up product also in f32), at the
     tiles the op resolves (gated: each gradient within 2e-2 (bf16) / 2e-4
     (f32) x max |plain|; two calls bit-equal; the SSD forward's output
     bit-equal with and without its states; no spilled bytes in either
     backward), each timed beside its bound, its plain version and, for
     the grouped matmul, ``torch.bmm`` of the same two products; (b)
     ``TrainLoop`` at full width, bf16, B 8 x S 256 from
     ``SyntheticStream``, weights at std 1 / sqrt(fan-in), on mamba2-130m
     (24 layers), qwen3-moe-235b-a22b cut to 1 of 94 layers, internlm2-1.8b,
     whisper-medium (its encoder and cross attention
     the first non-causal and cross uses of the flash backward on a model
     path) and grok-1-314b cut to 1 of 64 layers (6.53 B parameters: the
     softcapped d 128 flash backward and the grouped matmul's backward at
     8 experts x 640 rows); the models of ``BF16_OPT_STATE`` (qwen3-moe,
     grok-1) with bf16 AdamW moments, as the reference trains them: first
     the step-1 gradient against the same step with the
     plain ops (``flash_attention_plain``, ``ssd_scan_plain``,
     ``moe_gmm_plain`` with ``moe_gmm_backward_plain`` as its gradient;
     gated: every leaf finite and non-zero, each within
     5e-2 x max |g|, the loss within 1e-2; mamba2-130m's and qwen3-moe's
     gates hold the step in f32, the bf16 difference printed beside the
     bf16 floor of two plain SSDs at different chunks, or beside the two
     steps' routing agreement; grok-1's plain step keeps the grouped
     matmul's kernel, held alone in (a), and replays the kernel step's
     routing), then 3 steps (gated: finite
     losses; each forward and backward kernel of the model's path
     launched; a softcapped model's flash backward on the capped wgmma
     body, a MoE model's grouped-matmul backward at its capacity rows; the
     loop's parameter and moment tensors at the same addresses after the
     steps, which update them in place), ms per step, tokens/s, peak
     memory and one step's device busy share; then one JSON line
     ``{"train_more": ...}``.  The
     ``kernels`` line gains the two backward rows and the SSD, grouped
     matmul and flash rows ``train_more_path_launches``.
 30. gemma2-2b trained on the card: (a) the flash-attention backward with
     the forward's softcap and window against ``flash_attention_backward_
     plain``, bf16 on the wgmma body: gemma2's attention (8 / 4 heads, d
     256, softcap 50) at S 8192, global (causal) and local (window 4096),
     and at the training shape B 8 x S 256, where the window trims
     nothing; grok-1's (48 / 8 heads, d 128, softcap 30) at S 4096; a d 64
     shape with a window of 1024 at S 4096; and f32 on the SIMT body at a
     small softcapped and windowed shape; with a softcap q is scaled so
     the scores have std softcap / 2 (gated: dq, dk, dv each within 2e-2
     (bf16) / 2e-4 (f32) x max |plain|; the body, and whether its capped
     kernels ran; with a softcap, the plain backward with no cap and the
     one without the cap's derivative each fail that gate; two calls
     bit-equal; no spilled bytes in the wgmma kernels, registers printed
     at d 256; the profiler sees the three kernels), each timed beside its
     bound (2.5 x the forward's FLOPs over the pairs the mask leaves, or
     the bytes) and the plain version; no library time (SDPA takes no
     softcap); (b) ``TrainLoop`` on gemma2-2b at full width (26 layers,
     d 2304, bf16, f32 AdamW moments) as phase 29 (b) trains its models,
     with the flash forward and backward launches made with a window
     counted too (the counters' ``windowed``; gated as 29 (b), the capped
     wgmma body among it, and: 26 backward launches a step, 13 of them
     windowed); (c) one step at B 1 x S 8192, where the window trims the
     local layers' backward (gated: a finite loss, the windowed backward
     launched).  The ``kernels`` line gains the backward's row for these
     paths, ``flash_attention_backward_softcap_window``.
 31. ``distributed/`` on the card, NCCL at world size 1: (a)
     ``make_mesh((1, 1), ("data", "model"))`` (backend nccl, world size,
     ``mesh_chips``), ``Sharder(train_rules(fsdp=False))`` over
     llama3.2-1b's full-width specs (leaves sharded and dropped), and
     ``make_production_mesh()`` refused for want of 256 ranks; (b)
     ``TrainLoop(mesh=make_mesh((1,), ("data",)))`` beside
     ``TrainLoop(mesh=None)`` on llama3.2-1b and mamba2-130m at full width,
     B 8 x S 256, remat "full", 3 steps from the same weights (gated:
     losses, grad norms and every parameter and moment leaf bit-equal, as
     an all-reduce over one rank must be; the flash and SSD forward and
     backward launches equal), ms a step of both and the NCCL kernels'
     device time in one profiled step; (c) on llama's step-1 gradient tree
     over a (pod 1, data 1) mesh, ``hierarchical_pmean`` bit-equal to its
     input and ``compressed_pmean`` within scale / 2 of each leaf (two f32
     roundings allowed) with its residual = g - q * scale exactly, over
     two rounds (the second on g + the first's residual, which
     ``optim/compression.py``'s ``ef_compress_tree`` folds to the same
     residual); (d) ``gpipe_forward`` over a (pipe 1) mesh with llama's
     16-block stack as the stage, 4 microbatches of B 2 x S 1024 (gated:
     bit-equal to the stack on each microbatch, 64 flash launches); (e)
     (b)'s llama parameters saved and ``elastic_restore``'d onto a (data
     1, model 1) mesh (gated: every ``DTensor``'s full tensor bit-equal,
     on the card); (f) ``examples/serve_lm.py`` at full width
     (``--no-smoke``), synchronous and ``--async --trace`` (gated: every
     request served, the greedy tokens equal, spans in the trace; llama's
     serving steps launch no hand-written kernel: the decode step's
     attention is the reference's einsum).  The ``kernels`` line's flash,
     flash backward, SSD and SSD backward rows gain
     ``dp_train_path_launches`` (the mesh loops'), and the flash row
     ``gpipe_path_launches``.

The kernels' main paths are phases 4-5 (matmul), 8-9 (flash attention),
12-13 (SSD scan), 16 (grouped matmul, bf16, then f32), 18 (layernorm and
column sum; 19 is the entry point, read the same way), 20 (b) (the f32
SIMT matmul: the suite's probes and exhaustive passes), 21 (the bf16
matmul, flash attention and the SSD under launch and step plans) and 22
(flash attention and the grouped matmul in qwen3-moe's prefill and
engine; the drivers' builds and reads come before the counters start) and
23 (the grouped matmul in the engines' decode graphs; the matmul, flash
attention, the layernorm and the column sum through ``in_graph=``) and 24
(flash attention and the grouped matmul in each architecture's prefill
and engine, one path per architecture) and 25 (a) and (b) (the f32 matmul
and grouped matmul under the online search and the strategies' builds)
and 26 (the f32 matmul under the escalation's search, the telemetry
loop's probes and refit and the captured step, flash attention under
``tune_for_shape``'s search) and 27 (the bf16 matmul, flash attention,
the SSD and the grouped matmul in the farm's workers, the f32 matmul in
the kill drill, the serving side's probes and the farm's retune) and 28
(b) (flash attention's forward and backward kernels in ``TrainLoop``) and
29 (b) and 30 (b) (flash attention's, the SSD scan's and the grouped
matmul's forward and backward kernels in ``TrainLoop``, one path per
model) and 31 (b) and (d) (flash attention's and the SSD scan's forward
and backward kernels in the data-parallel ``TrainLoop``, flash attention
in GPipe's stages):
each launch counter is set to 0
just before its path and read just after it; launches made to compare a
kernel with its plain version or to time it come after the read.  A
wrapper counts the launches it makes eagerly; a CUDA graph records its
launches per replay at its capture (which launches nothing, so the capture
leaves the counters as they were), and a path's count adds each graph's
replays times those.  The
driver cache (``$KLARAPTOR_CACHE_DIR``) is an empty temporary directory
for the whole run, so every phase probes on the card and no run reads an
earlier run's drivers.
After the last phase one line gives every phase's wall seconds and their
sum.  The line before the last is one JSON object with each kernel's
numbers; the last is ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits nonzero.  Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# llama3.2-1b GEMMs at T = 4096 tokens: (name, m, n, k).
SHAPES = (
    ("q_o_proj", 4096, 2048, 2048),
    ("k_v_proj", 4096, 512, 2048),
    ("gate_up", 4096, 8192, 2048),
    ("down", 4096, 2048, 8192),
    ("unembed", 4096, 128256, 2048),
)
RATIO_SHAPES = ("q_o_proj", "k_v_proj", "gate_up")
PEAK_BF16 = 989e12     # H100 SXM dense tensor-core rate
PEAK_F32 = 67e12       # H100 SXM FP32 on the CUDA cores
HBM_BW = 3.35e12       # H100 SXM HBM3
SEED = 0
SPIN_CYCLES = 4_000_000   # about 2 ms at the H100's boost clock
PARENT_SRC = None         # --parent-src: a checkout's src timed in [29] (a)

# Flash attention: the prefill shape (llama3.2-1b, B = 1, S = 4096) and the
# sweep of phase 7.
PREFILL_S = 4096
FLASH_SWEEP_S = 333                     # a length no tile divides
FLASH_VARIANTS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window64": dict(causal=True, window=64),
    "softcap30": dict(causal=True, softcap=30.0),
}
# Logits of the tuned prefill against the same step with plain attention:
# both are bf16 models whose attention outputs differ by bf16 roundings of
# f32 sums taken in different orders, amplified through 16 layers; a broken
# kernel differs by the logits' own size.
LOGIT_REL_TOL = 5e-2
N_REQUESTS, ENGINE_SLOTS, ENGINE_MAX_SEQ, MAX_NEW = 8, 4, 256, 16

# The SSD scan: the sweep of phase 11, and the gate of phases 13 and 14 --
# the logits of the tuned mamba2-130m prefill against the same step with the
# plain SSD, relative to max |logit|; a broken kernel differs by the logits'
# own size.  In bf16 two correct SSDs that round in different places already
# differ by about 10 % after 24 layers of this randomly initialised model (the
# plain version at two chunks, printed beside it), so the bf16 logits are
# printed against that floor and the gate holds the same step on the same
# weights in f32, where the floor is under 1e-3.
SSD_SWEEP_S = 333                       # a length no chunk divides
SSD_DT_RANGES = {"dt 0.01-0.51": (0.01, 0.51), "dt 1e-3-1e-2": (1e-3, 1e-2)}
SSD_LOGIT_REL_TOL = 5e-2

# The grouped matmul of phase 16: qwen3-moe-235b's expert width (d_model
# 4096, expert d_ff 1536, src/repro/configs/qwen3_moe_235b.py) with 8 local
# experts of 4096 tokens each, the reference's own bench shape
# (benchmarks/bench_telemetry.py); (name, k, n) of the up and down product.
GMM_E, GMM_G = 8, 4096
GMM_SHAPES = (("up", 4096, 1536), ("down", 1536, 4096))
# Phase 25: the f32 SIMT matmul's search size (Fig. 1's N); the grouped
# matmul's is phase 16's up product.
SEARCH_N = 2048
# Phase 18: llama3.2-1b's d_model and the reference's auto-kernel shapes
# (benchmarks/bench_introspect.py), plus a row count no multiple of 8
# divides (the layernorm's masked last row block).
AUTO_D_MODEL = 2048
LN_ROWS = (4096, 16384, 4097)
COLSUM_SHAPES = ((8192, 4096), (2048, 8192))
# Phase 28: llama3.2-1b's training batch (B x S tokens) and steps.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 10
# Phase 29: the models trained beyond llama, (arch, layers kept or None for
# all) at phase 28's batch, and the loop's steps; the SSD backward's shapes
# at mamba2-130m's (dh 64, n 128): (name, bh, heads sharing B and C, S).
TRAIN_MORE = (("mamba2-130m", None), ("qwen3-moe-235b-a22b", 1),
              ("internlm2-1.8b", None), ("whisper-medium", None),
              ("grok-1-314b", 1))
TRAIN_MORE_STEPS = 3
# Models whose step-1 gradient is gated in f32.  In bf16 two correct SSDs
# that round in different places (the plain version at chunks 256 and 64)
# already give gradients 2e-1 of max |g| apart after mamba2-130m's 24 layers
# (phase 29 prints that floor beside the kernel's difference), as its bf16
# logits are (phase 13); and bf16 roundings move qwen3-moe's top-8 routing
# for some tokens, which moves whole rows of the router's and the experts'
# gradients (phase 29 prints the two steps' routing agreement).  In f32
# both hold the gate.
STEP1_F32 = ("mamba2-130m", "qwen3-moe-235b-a22b")
# Models whose step 1 is held in bf16 against a step with plain attention
# that keeps the grouped matmul's kernel (its forward and backward held
# alone against the plain ones at the same shapes, on
# GMM_BWD_GATED_EXPERTS, in phase 29 (a); the plain version takes seconds
# an expert there) and
# replays the kernel step's routing, so that no bf16 rounding moves a
# top-k choice: grok-1, whose f32 step (26 GB of parameters and two
# 26 GB gradients) does not fit the card.  The models of the port's
# BF16_OPT_STATE (the reference's) train with bf16 AdamW moments.
STEP1_REPLAYED_ROUTING = ("grok-1-314b",)
# Phase 29 (a): the grouped matmul's backward at the MoE layers' training
# shapes (B 8 x S 256), (arch, dtype); grok-1 is gated against the plain
# version on these experts of its eight (the plain backward takes seconds
# an expert there).
GMM_BWD_SHAPES = (("qwen3-moe-235b-a22b", "bf16"), ("qwen3-moe-235b-a22b",
                                                    "f32"),
                  ("grok-1-314b", "bf16"))
GMM_BWD_GATED_EXPERTS = (0, 7)
SSD_BWD_SHAPES = (("train", TRAIN_B * 24, 24, TRAIN_S),
                  ("prefill", 24, 24, PREFILL_S))
# Phase 30: gemma2-2b, its long-context length ([24]'s prefill), and the
# backward alone: (name, B, S, q heads, kv heads, d, window, softcap,
# dtype), causal; the window trims nothing at S 256.
# Phase 31: the models trained on a (data 1) mesh beside the one-process
# loop, at phase 28's batch, and their steps; GPipe's microbatches (n, B,
# S) of llama3.2-1b.
DP_ARCHS = ("llama3.2-1b", "mamba2-130m")
DP_STEPS = 3
GPIPE_MICRO, GPIPE_B, GPIPE_S = 4, 2, 1024
GEMMA2_ARCH = "gemma2-2b"
GEMMA2_S = 8192
MASKED_BWD_SHAPES = (
    ("gemma2_global", 1, GEMMA2_S, 8, 4, 256, None, 50.0, "bf16"),
    ("gemma2_local", 1, GEMMA2_S, 8, 4, 256, 4096, 50.0, "bf16"),
    ("gemma2_train_global", TRAIN_B, TRAIN_S, 8, 4, 256, None, 50.0, "bf16"),
    ("gemma2_train_local", TRAIN_B, TRAIN_S, 8, 4, 256, 4096, 50.0, "bf16"),
    ("grok1", 1, PREFILL_S, 48, 8, 128, None, 30.0, "bf16"),
    ("d64_window1024", 1, PREFILL_S, 32, 8, 64, 1024, None, "bf16"),
    ("f32_simt", 2, 333, 4, 2, 64, 100, 30.0, "f32"),
)


GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas", "nvjet")
FLASH_PROFILE_GROUPS = (("flash", ("flash_",)), ("gemm", GEMM_NAMES))
SSD_PROFILE_GROUPS = (("ssd", ("ssd_",)), ("gemm", GEMM_NAMES))
TRAIN_PROFILE_GROUPS = (("flash_fwd", ("flash_sm90", "flash_fwd")),
                        ("flash_bwd", ("flash_bwd",)), ("gemm", GEMM_NAMES))
TRAIN_MORE_PROFILE_GROUPS = (
    ("flash_fwd", ("flash_sm90", "flash_fwd")), ("flash_bwd", ("flash_bwd",)),
    ("ssd_fwd", ("ssd_sm90", "ssd_simt")), ("ssd_bwd", ("ssd_bwd",)),
    ("gmm_fwd", ("gemm_sm90::",)), ("gmm_bwd", ("gmm_bwd_sm90::",)),
    ("gemm", GEMM_NAMES))
# The bf16 flash backward's three kernels, the calls of it and of SDPA's
# backward in one profile of [28] (a), and the seconds the host waits before
# and after them inside the profile.
BWD_SPLIT_GROUPS = (("prep", ("flash_bwd_prep",)),
                    ("dkdv", ("flash_bwd_dkdv_sm90",)),
                    ("dq", ("flash_bwd_dq_sm90",)))
BWD_PROFILE_CALLS = 10
BWD_PROFILE_PAD_S = 2.0


def _device_profile(fn, what: str,
                    groups: tuple = FLASH_PROFILE_GROUPS,
                    cpu: bool = True, ranges: tuple = ()) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print the device time
    by kernel group and the device-busy share of the window's wall time
    (inflated by the profiler's own overhead).  ``groups`` = ((group, name
    fragments), ...): a kernel joins the first group one of whose fragments
    its name holds, else "other".  ``ranges`` names ``record_function``
    ranges inside ``fn``: a kernel that ran inside a range's span on the
    device (the range's device-side annotation, from the start of its first
    kernel to the end of its last; the run is one stream) forms a group of
    the range's name, before ``groups`` are tried.  Every kernel execution
    is counted once, in one group, so no group can read below 0 (gated).
    Beside each range it prints what the walk of the range's nested ops
    lists (``walk_ms``), the split's earlier way, which counted some kernels
    twice: where the launch queue fills, the profiler nests a "Command
    Buffer Full" event under the launching op with the op's correlation id,
    and attaches the op's kernels to it too.  ``cpu=False`` traces
    the device alone (no host op events: less overhead, and less to
    aggregate; no ``ranges``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals = {r: 0.0 for r in ranges} | {g: 0.0 for g, _ in groups} \
        | {"other": 0.0}
    events = prof.events()
    on_device = [ev for ev in events
                 if str(ev.device_type).endswith("CUDA")]
    spans = {r: [(ev.time_range.start, ev.time_range.end)
                 for ev in on_device if ev.name == r] for r in ranges}
    by_name = {}
    for ev in on_device:
        if ev.name in ranges or getattr(ev, "is_user_annotation", False):
            continue                # a range's own span on the device
        t0_, t1_ = ev.time_range.start, ev.time_range.end
        ms = (t1_ - t0_) / 1e3
        group = next((r for r in ranges if any(a <= t0_ and t1_ <= b
                                               for a, b in spans[r])), None)
        if group is None:
            name = ev.name.lower()
            group = next((g for g, frags in groups
                          if any(f in name for f in frags)), "other")
        totals[group] += ms
        n_ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (n_ms + ms, n + 1)
    # the op walk the split used before: each nested op's kernels
    walk = {}

    def under(ev):
        for child in ev.cpu_children:
            yield child
            yield from under(child)

    for ev in events:
        if ev.name in ranges and str(ev.device_type).endswith("CPU"):
            walk[ev.name] = walk.get(ev.name, 0.0) + sum(
                k.duration for op in under(ev) for k in op.kernels) / 1e3
    missing = [r for r in ranges if not spans[r]]
    if missing:
        raise AssertionError(f"profile of {what}: no device-side span of "
                             f"the ranges {missing}")
    busy = sum(totals.values())
    if busy <= 0.0:
        print(f"  profile of {what}: the profiler saw no device time ("
              f"{len(events)} events, device types "
              f"{sorted({str(ev.device_type) for ev in events})}); device "
              f"time not measured")
        return {}
    below = {g: ms for g, ms in totals.items() if ms < 0.0}
    if below:
        raise AssertionError(f"profile of {what}: groups below 0: {below}")
    print(f"  profile of {what} (torch.profiler): wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms ({busy / wall_ms:.1%}); "
          + ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})"
                      for g, ms in totals.items())
          + "".join(f"; {r} by the op walk {walk.get(r, 0.0):.2f} ms"
                    for r in ranges), flush=True)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **totals,
            **{f"{r}_walk_ms": walk.get(r, 0.0) for r in ranges}}


def _visible_pairs(sq: int, skv: int, causal: bool,
                   window: int | None = None) -> int:
    """(query, key) pairs flash attention computes: key j visible to query
    i when j <= i (causal) and i - j < window (a window)."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def _flash_bound_ms(bh: int, sq: int, skv: int, hkv_rows: int, d: int,
                    causal: bool, elem: int,
                    window: int | None = None) -> tuple[float, str]:
    """Least time of one flash-attention call on the card: q, k, v read
    once and the output written once, and 4 d FLOPs per visible (query,
    key) pair (``_visible_pairs``) at the tensor-core peak of bf16
    inputs."""
    pairs = _visible_pairs(sq, skv, causal, window)
    t_ops = 4.0 * d * bh * pairs / PEAK_BF16
    t_bytes = (2 * bh * sq + 2 * hkv_rows * skv) * d * elem / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _ssd_bound_ms(bh: int, s: int, dh: int, n: int, chunk: int,
                  elem: int, groups: int) -> tuple[float, str]:
    """Least time of one SSD scan on the card: x, f32 dt and A read once,
    B and C read once for each of ``groups`` (bh / h: ``groups`` = 1 when
    the heads share them, as the kernel reads them; bh when they come per
    head, as the reference's interface hands them over) and y written once,
    and the FLOPs of the chunked form at ``chunk`` (per chunk of l rows: the
    causal C B^T and its product with x, (n + dh) l (l + 1), and the carried
    state's output term and update, 4 n dh l) at the tensor-core peak of
    bf16 inputs (the FP32 rate for f32)."""
    ops = 0.0
    for c0 in range(0, s, chunk):
        rows = min(chunk, s - c0)
        ops += (n + dh) * rows * (rows + 1) + 4.0 * n * dh * rows
    t_ops = bh * ops / (PEAK_BF16 if elem == 2 else PEAK_F32)
    t_bytes = (bh * s * 2 * dh * elem + groups * s * 2 * n * elem
               + bh * (s + 1) * 4) / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _upcast(tree: dict) -> dict:
    """A parameter tree with every tensor in f32."""
    return {k: _upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """Least time of a bf16 GEMM on the card: each input read once, the
    output written once, and 2mnk FLOPs at the tensor-core peak."""
    t_ops = 2.0 * m * n * k / PEAK_BF16
    t_bytes = (m * k + k * n + m * n) * 2 / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _print_captures(engine) -> None:
    """An engine's step builds and, per live captured graph, its capture
    seconds (of them recording), the memory its capture added to the pool,
    and its kernel launches per replay and replays."""
    print(f"  compile_counts {engine.compile_counts}", flush=True)
    for step in engine.captures():
        print(f"    graph: capture {step.capture_s:.3f} s (recording "
              f"{step.record_s:.3f} s), pool +"
              f"{step.pool_bytes / 2**20:.1f} MiB, launches per replay "
              f"{step.launches or 'none of the tuned kernels'}, "
              f"{step.replays} replays", flush=True)


def _cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump (beside nvcc)."""
    import os
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found on PATH or under CUDA_HOME")
    return path


def main() -> int:
    global PARENT_SRC
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--parent-src", help="another checkout's src: phase 29 "
                    "(a) times its grouped-matmul backward beside this one's, "
                    "in turns")
    PARENT_SRC = ap.parse_args().parent_src
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    caches = []
    try:
        return run(caches)
    finally:
        for d in caches:
            shutil.rmtree(d, ignore_errors=True)


def fresh_cache(caches: list) -> str:
    """Point the driver cache at a new empty directory (removed at exit)."""
    d = tempfile.mkdtemp(prefix="klaraptor-cache-")
    caches.append(d)
    os.environ["KLARAPTOR_CACHE_DIR"] = d
    return d


def run(caches: list) -> int:
    import torch

    fresh_cache(caches)

    from repro_torch.core import (CudaEventTimer, HardwareParams, Klaraptor,
                                  matmul_spec, registry, selection_ratio)
    from repro_torch.core.kernel_spec import (FLASH_HEAD_DIMS,
                                              FLASH_SM90_HEAD_DIMS,
                                              FLASH_SM90_REGS_PER_THREAD,
                                              FLASH_SM90_TILES, SM90_TILES,
                                              SSD_REGS_PER_THREAD,
                                              SSD_SM90_CHUNKS,
                                              SSD_SM90_REGS_PER_THREAD,
                                              SSD_SM90_SHAPES,
                                              flash_regs_per_thread)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.layernorm import LAYERNORM
    from repro_torch.kernels.matmul import (LAUNCHES, MATMUL, OUT_DTYPES,
                                            matmul_kernel, matmul_plain)
    from repro_torch.kernels.moe_gmm import MOE_GMM
    from repro_torch.kernels.reduce import COLSUM

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def time_ms(fn, target_ms: float = 40.0, max_iters: int = 20) -> float:
        """Mean ms of fn() from CUDA events over launches queued behind a
        spin of the card, after one warm-up launch; the median of three such
        loops (one where a loop is one call, as for the plain versions)."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        once = start.elapsed_time(end)
        iters = int(min(max(target_ms / max(once, 1e-3), 1), max_iters))
        loops = []
        for _ in range(3 if max_iters > 1 else 1):
            # the card spins (about 2 ms) while the host queues the
            # launches, so a kernel shorter than its wrapper's host time is
            # timed alone
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            loops.append(start.elapsed_time(end) / iters)
        return sorted(loops)[len(loops) // 2]

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def check(a, b, dtype, what: str, f32_tol=(2e-4, 2e-4),
              quiet: bool = False) -> float:
        atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else f32_tol
        torch.cuda.synchronize()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite output")
        ok = torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
        err = max_err(a, b)
        if not (quiet and ok):
            print(f"  {what}: max_abs_err={err:.3e} atol={atol:g} "
                  f"rtol={rtol:g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: kernel disagrees with plain")
        return err

    clock = [time.perf_counter()]
    walls: dict[int, float] = {}

    def phase_done(n: int) -> None:
        now = time.perf_counter()
        walls[n] = now - clock[0]
        print(f"  (phase {n}: {walls[n]:.2f} s wall)", flush=True)
        clock[0] = now

    # -- 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print("[1] card")
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}", flush=True)
    hw = HardwareParams.from_device(dev)
    print(f"  hw: {hw}")
    phase_done(1)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[2] build: {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True, check=True)
        hgmma = sum("HGMMA" in ln for ln in sass.stdout.splitlines())
        print(f"  {lib.name}: {hgmma} HGMMA instructions in the SASS")
        if hgmma == 0 and lib.name.startswith(("libmatmul-", "libmoe_gmm-",
                                               "libflash_attention-",
                                               "libflash_attention_bwd-",
                                               "libssd_scan-",
                                               "libssd_scan_bwd-")):
            raise AssertionError(f"{lib.name} has no wgmma (HGMMA) in its "
                                 f"SASS: the bf16 path is not on the tensor "
                                 f"cores")
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels.matmul import tile_attributes
    for kern, tile_attrs in ((MATMUL, tile_attributes),
                             (gmm_mod.MOE_GMM, gmm_mod.tile_attributes)):
        cap = kern.regs_cap_for(torch.bfloat16)
        for t in SM90_TILES:
            attrs = tile_attrs(*t)
            print(f"  {kern.source} bf16 wgmma tile {t}: {attrs} (cap {cap})")
            if attrs["num_regs"] > cap or attrs["local_bytes"]:
                raise AssertionError(f"{kern.source} tile {t}: {attrs} "
                                     f"against the cap {cap}, no spills")
    ptxas = [ln.strip() for ln in _build.build_log("matmul").splitlines()
             if "registers" in ln or "spill" in ln]
    print("  " + "\n  ".join(ptxas))
    for dt in (torch.bfloat16, torch.float32):
        attrs = MATMUL.attributes(dt)
        print(f"  matmul {dt}: {attrs} (cap {MATMUL.regs_cap_for(dt)})")
        if attrs["num_regs"] > MATMUL.regs_cap_for(dt):
            raise AssertionError(
                f"kernel uses {attrs['num_regs']} registers; the spec "
                f"assumes {MATMUL.regs_cap_for(dt)}")
    for kern in (MATMUL, MOE_GMM):
        attrs = kern.attributes(torch.float32)
        cap = kern.regs_cap_for(torch.float32)
        print(f"  {kern.source} f32 SIMT mainloop (gemm_simt.cuh): "
              f"{attrs['num_regs']} registers per thread (cap {cap}), "
              f"{attrs['local_bytes']} local (spill) bytes")
        if attrs["num_regs"] > cap or attrs["local_bytes"]:
            raise AssertionError(f"{kern.source} f32: {attrs} against the "
                                 f"cap {cap}, no spills")
    flash_ptxas = [ln.strip() for ln in
                   _build.build_log("flash_attention").splitlines()
                   if "registers" in ln or "spill" in ln or "wgmma" in ln]
    print("  flash_attention ptxas:\n  " + "\n  ".join(flash_ptxas))
    for d in FLASH_SM90_HEAD_DIMS:
        for bq, bkv in FLASH_SM90_TILES[d]:
            attrs = flash.tile_attributes(d, bq, bkv)
            print(f"  flash bf16 wgmma d={d} tile ({bq}, {bkv}): {attrs} "
                  f"(cap {FLASH_SM90_REGS_PER_THREAD})")
            if attrs["num_regs"] > FLASH_SM90_REGS_PER_THREAD \
                    or attrs["local_bytes"]:
                raise AssertionError(
                    f"flash wgmma tile d={d} ({bq}, {bkv}): {attrs} against "
                    f"the cap {FLASH_SM90_REGS_PER_THREAD}, no spills")
    for d in FLASH_HEAD_DIMS:
        for bkv in flash.BKV_TILES:
            attrs = flash.kernel_attributes(torch.float32, d, bkv)
            print(f"  flash SIMT f32 d={d} bkv={bkv}: {attrs}")
            if attrs["num_regs"] > flash_regs_per_thread(d):
                raise AssertionError(
                    f"flash kernel d={d} bkv={bkv} uses "
                    f"{attrs['num_regs']} registers; the spec assumes "
                    f"{flash_regs_per_thread(d)}")
    ssd_ptxas = [ln.strip() for ln in _build.build_log("ssd_scan").splitlines()
                 if "registers" in ln or "spill" in ln]
    print("  ssd_scan ptxas:\n  " + "\n  ".join(ssd_ptxas))
    for dt in (torch.bfloat16, torch.float32):
        attrs = ssd.kernel_attributes(dt)
        print(f"  ssd_scan SIMT {dt}: {attrs}")
        if attrs["num_regs"] > SSD_REGS_PER_THREAD:
            raise AssertionError(
                f"SSD kernel uses {attrs['num_regs']} registers; the spec "
                f"assumes {SSD_REGS_PER_THREAD}")
    for dh, n in SSD_SM90_SHAPES:
        for chunk in SSD_SM90_CHUNKS:
            attrs = ssd.tile_attributes(dh, n, chunk)
            print(f"  ssd_scan bf16 wgmma (dh {dh}, n {n}) chunk {chunk}: "
                  f"{attrs} (cap {SSD_SM90_REGS_PER_THREAD})")
            if attrs["num_regs"] > SSD_SM90_REGS_PER_THREAD \
                    or attrs["local_bytes"]:
                raise AssertionError(
                    f"SSD wgmma chunk {chunk}: {attrs} against the cap "
                    f"{SSD_SM90_REGS_PER_THREAD}, no spills")
    for kern in (MOE_GMM, LAYERNORM, COLSUM):
        lines = [ln.strip() for ln in
                 _build.build_log(kern.source).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {kern.source} ptxas:\n  " + "\n  ".join(lines))
        for dt in (torch.bfloat16, torch.float32):
            attrs = kern.attributes(dt)
            cap = kern.regs_cap_for(dt)
            print(f"  {kern.source} {dt}: {attrs} (launch-bounds cap {cap})")
            if attrs["num_regs"] > cap:
                raise AssertionError(
                    f"{kern.source} uses {attrs['num_regs']} registers, "
                    f"above its cap {cap}")
    phase_done(2)

    # -- 3. the kernel against its plain version --------------------------------
    print("[3] kernel vs plain (tolerance: 2e-2 bf16, 2e-4 f32, atol=rtol, "
          "the repo's kernel-test tolerances; both sum in f32, in different "
          "orders, and bf16 outputs round once)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(m, n, k, dtype):
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        y = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
             ).to(dtype)
        return x, y

    worst = 0.0
    D = {"m": 256, "n": 512, "k": 1024}
    x, y = inputs(D["m"], D["n"], D["k"], torch.bfloat16)
    plain = matmul_plain(x, y, torch.float32)
    errs = []
    for t in SM90_TILES:
        for od in OUT_DTYPES:
            out = matmul_kernel(x, y, bm=t[0], bn=t[1], bk=t[2],
                                out_dtype=od)
            if out.dtype != od:
                raise AssertionError(f"tile {t}: output {out.dtype}")
            errs.append(check(out, plain, torch.bfloat16,
                              f"bf16 {D} {t} -> {od}", quiet=True))
    worst = max([worst] + errs)
    print(f"  bf16 {D}: {len(SM90_TILES)} compiled wgmma tiles x "
          f"{len(OUT_DTYPES)} output types, max_abs_err={max(errs):.3e} ok",
          flush=True)
    D = {"m": 512, "n": 1024, "k": 1024}
    table = matmul_spec(4).candidates(D, hw)
    x, y = inputs(D["m"], D["n"], D["k"], torch.float32)
    plain = matmul_plain(x, y)
    errs = []
    for i in range(len(table)):
        P = table.row(i)
        errs.append(check(matmul_kernel(x, y, **P), plain, torch.float32,
                          f"f32 SIMT {D} {P}", quiet=True))
        xs, ys = x[:, :P["bk"]].contiguous(), y[:P["bk"]].contiguous()
        errs.append(check(matmul_kernel(xs, ys, **P), matmul_plain(xs, ys),
                          torch.float32, f"f32 SIMT k = bk {P}",
                          quiet=True))
    for od in (torch.bfloat16, torch.float16):
        out = matmul_kernel(x, y, bm=64, bn=128, bk=32, out_dtype=od)
        errs.append(check(out, plain, torch.bfloat16,
                          f"f32 SIMT -> {od}", quiet=True))
    worst = max([worst] + errs)
    print(f"  f32 SIMT: every feasible tile ({len(table)}) at {D} (k / bk "
          f"4-128: the 3-slot ring wraps) and at k = bk (one k step), and "
          f"f32 -> bf16 / f16 outputs: {len(errs)} launches, "
          f"max_abs_err={max(errs):.3e} ok", flush=True)
    kept = {}
    for name, m, n, k in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, y = inputs(m, n, k, dtype)
            plain = matmul_plain(x, y)
            kname = ops.matmul_kernel_name(dtype)
            cfg = ops._fit_gemm(kname, ops._DEFAULTS[kname],
                                {"bm": m, "bn": n, "bk": k})
            out = matmul_kernel(x, y, **cfg)
            worst = max(worst, check(out, plain, dtype,
                                     f"{dtype} {name} ({m},{n},{k}) {cfg}"))
            del out
            if dtype == torch.bfloat16:
                kept[name] = (x, y, plain)
            del x, y, plain
    x, y, plain = kept["q_o_proj"]
    out = matmul_kernel(x, y, bm=128, bn=128, bk=64, out_dtype=torch.float32)
    worst = max(worst, check(out, plain, torch.bfloat16,
                             "bf16 in, f32 out q_o_proj"))
    del out
    torch.cuda.empty_cache()
    phase_done(3)

    # -- 4. KLARAPTOR on the card (the main path starts here) -----------------
    LAUNCHES.reset()
    registry.clear()
    spec = matmul_spec(dtype_bytes=2)
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    build = Klaraptor(timer).build_driver(spec, repeats=2,
                                          max_configs_per_size=24)
    cols = build.collected.columns
    biggest = max(int(cols[d].max()) for d in ("m", "n", "k"))
    print("[4] KLARAPTOR build on the card")
    print("  " + build.fit_report().replace("\n", "\n  "))
    print(f"  probe sizes: m, n, k <= {biggest}; probe executions "
          f"{build.collected.n_probe_executions}; probe device seconds "
          f"{build.probe_device_seconds:.4f}", flush=True)
    if biggest > 1024:
        raise AssertionError(f"probed a size of {biggest} > 1024")
    if registry.get(spec.name) is not build.driver:
        raise AssertionError("the driver was not registered")
    phase_done(4)

    # -- 5. tuned launch through ops.matmul -----------------------------------
    print("[5] tuned launch through ops.matmul")
    tuned = {}
    for name, m, n, k in SHAPES:
        x, y, plain = kept[name]
        before = LAUNCHES.count
        out = ops.matmul(x, y)
        if LAUNCHES.count != before + 1:
            raise AssertionError(f"{name}: ops.matmul launched "
                                 f"{LAUNCHES.count - before} kernels, not 1")
        if tuple(out.shape) != (m, n) or out.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: output {out.shape} {out.dtype}")
        worst = max(worst, check(out, plain, torch.bfloat16,
                                 f"tuned {name} vs plain"))
        tuned[name] = build.driver.choose({"m": m, "n": n, "k": k})
        del out
    launches = LAUNCHES.count       # the main path ends here
    print(f"  main-path launches: {launches} (probes and tuned calls)")
    if launches < 1 + len(SHAPES):
        raise AssertionError("the main path did not launch the kernel")

    rows = []
    for name, m, n, k in SHAPES:
        x, y, plain = kept.pop(name)
        cfg = tuned[name]
        dflt = ops._fit_gemm("matmul_b16", ops.MATMUL_DEFAULT,
                             {"bm": m, "bn": n, "bk": k})
        bound, bound_by = _bound_ms(m, n, k)
        r = {
            "shape": name, "m": m, "n": n, "k": k, "config": cfg,
            "default": dflt,
            "ms": time_ms(lambda: matmul_kernel(x, y, **cfg)),
            "default_ms": time_ms(lambda: matmul_kernel(x, y, **dflt)),
            "library_ms": time_ms(lambda: torch.matmul(x, y)),
            "plain_ms": time_ms(lambda: matmul_plain(x, y), max_iters=1),
            "bound_ms": bound, "bound_by": bound_by,
        }
        r["tflops"] = 2.0 * m * n * k / (r["ms"] * 1e-3) / 1e12
        r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
        rows.append(r)
        print(f"  {name} ({m},{n},{k}) chosen {cfg} {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s, {r['pct_of_bound']:.1f} % of "
              f"bound) | default {dflt} {r['default_ms']:.4f} ms | "
              f"torch.matmul {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x) | plain "
              f"{r['plain_ms']:.2f} ms | bound {r['bound_ms']:.4f} ms "
              f"({bound_by})", flush=True)
        del x, y, plain
        torch.cuda.empty_cache()
    phase_done(5)

    # -- 6. selection ratio against exhaustive search ---------------------------
    print("[6] selection ratio (exhaustive: 1 warm-up + median of 3 timed "
          "launches per candidate; printed, not gated)")
    for name, m, n, k in SHAPES:
        if name not in RATIO_SHAPES:
            continue
        r = selection_ratio(spec, timer, build.driver,
                            {"m": m, "n": n, "k": k}, hw)
        print(f"  {name} ({m},{n},{k}): chosen {r['chosen']} "
              f"{r['chosen_time_s'] * 1e3:.4f} ms, best {r['best']} "
              f"{r['best_time_s'] * 1e3:.4f} ms of {r['n_configs']}, "
              f"ratio {r['ratio']:.3f}", flush=True)

    phase_done(6)
    matmul_total = {key: sum(r[key] for r in rows)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    matmul_row = {
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:46",
        "launches": launches,
        "max_abs_err": worst,
        "ms": matmul_total["ms"],
        "plain_ms": matmul_total["plain_ms"],
        "bound_ms": matmul_total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in rows) else "bytes",
        "library_ms": matmul_total["library_ms"],
        "shapes": [{k: r[k] for k in ("shape", "m", "n", "k", "config",
                                      "ms", "tflops", "pct_of_bound",
                                      "default_ms", "library_ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows],
    }
    flash_row, flash_ctx = flash_phases(dev, hw, gen, check, time_ms,
                                        phase_done)
    ssd_row, ssd_ctx = ssd_phases(dev, hw, gen, check, time_ms, phase_done)
    gmm32_row, gmm_row, gmm_ctx = gmm_phases(dev, hw, gen, check, time_ms,
                                             phase_done)
    gmm32_pass = gmm_ctx.pop("f32_pass")
    introspect_phase(hw, phase_done)
    ln_row, cs_row = auto_phases(dev, hw, gen, check, time_ms, phase_done,
                                 caches)
    simt_row = paper_phase(dev, hw, check, time_ms, phase_done, caches)
    plan_launches = plan_phase(
        dev, hw, gen, check, phase_done, caches, card,
        {"matmul": (spec, build.driver), "flash": flash_ctx,
         "ssd": ssd_ctx})
    for row, name in ((matmul_row, "matmul"), (flash_row, "flash"),
                      (ssd_row, "ssd")):
        row["plan_path_launches"] = plan_launches[name]
    drivers = [flash_ctx["driver"]]
    del flash_ctx, ssd_ctx
    torch.cuda.empty_cache()
    moe = moe_phase(dev, hw, gen, check, time_ms, phase_done, caches, card,
                    gmm_ctx)
    for row, name in ((flash_row, "flash"), (gmm_row, "moe_gmm")):
        row["qwen3_moe_path_launches"] = moe["launches"][name]
    flash_row["qwen3_moe"] = moe["flash"]
    gmm_row["qwen3_moe"] = moe["moe_gmm"]
    gmm_row["max_abs_err"] = max(gmm_row["max_abs_err"], moe["max_abs_err"])
    flash_row["max_abs_err"] = max(flash_row["max_abs_err"],
                                   moe["flash"]["max_abs_err"])
    eng = engine_phase(dev, hw, gen, check, phase_done, caches, card,
                       (spec, build.driver), moe)
    drivers += moe["drivers"]
    del moe
    archs = archs_phase(dev, hw, check, time_ms, phase_done, caches, card,
                        drivers)
    for row, name in ((flash_row, "flash_attention"), (gmm_row, "moe_gmm")):
        row["archs_path_launches"] = archs["launches"][name]
        row["archs"] = archs[name]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 archs["max_abs_err"][name])
    search = search_phase(hw, phase_done, caches, gmm32_pass)
    for row in (simt_row, gmm32_row):
        row["search_path_launches"] = search["launches"][row["name"]]
    observed = observed_phase(hw, phase_done, caches, card,
                              search["mm_pass"])
    # the phase launches no bf16 matmul or grouped matmul: the matmul and
    # grouped-matmul counters' launches are the f32 rows'
    for row, name in ((matmul_row, None), (flash_row, "flash_attention"),
                      (ssd_row, "ssd_scan"), (gmm_row, None),
                      (ln_row, "layernorm"), (cs_row, "colsum"),
                      (simt_row, "matmul"), (gmm32_row, "moe_gmm")):
        row["telemetry_path_launches"] = \
            observed["launches"][name] if name else 0
    farm = fleet_phase(hw, phase_done, caches, card, search["mm_pass"])
    # (a) launches the bf16 rows' kernels, (b) and (c) the f32 matmul
    for row, part, name in ((matmul_row, "bf16", "matmul"),
                            (flash_row, "bf16", "flash_attention"),
                            (ssd_row, "bf16", "ssd_scan"),
                            (gmm_row, "bf16", "moe_gmm"),
                            (ln_row, "f32", "layernorm"),
                            (cs_row, "f32", "colsum"),
                            (simt_row, "f32", "matmul"),
                            (gmm32_row, "f32", "moe_gmm")):
        row["fleet_path_launches"] = farm["launches"][part].get(name, 0)
    for row, name in ((matmul_row, "matmul"), (flash_row, "flash_attention"),
                      (ssd_row, "ssd_scan"), (gmm_row, "moe_gmm"),
                      (ln_row, "layernorm"), (cs_row, "colsum")):
        row["engine_path_launches"] = eng["launches"][name]
        row["engine_path_graph_launches"] = eng["graphed"].get(name, 0)
        if name in eng["max_abs_err"]:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     eng["max_abs_err"][name])
    train = train_phase(dev, hw, gen, check, time_ms, phase_done, card)
    flash_row["train_path_launches"] = train["flash_launches"]
    more = train_more_phase(dev, gen, time_ms, phase_done, card)
    for row, name in ((flash_row, "flash_attention"), (ssd_row, "ssd_scan"),
                      (gmm_row, "moe_gmm"),
                      (train["row"], "flash_attention_backward")):
        row["train_more_path_launches"] = more["launches"][name]
    gemma = gemma2_phase(dev, gen, time_ms, phase_done, card)
    for row, name in ((flash_row, "flash_attention"),
                      (train["row"], "flash_attention_backward")):
        row["gemma2_path_launches"] = gemma["launches"][name]
    # grok-1's training path (phase 29 (b)): the softcapped d 128 flash
    # backward and the grouped-matmul backward at 8 experts x 640 rows
    grok = more["by_model"]["grok-1-314b"]
    gemma["row"]["grok1_train_path_launches"] = \
        grok["flash_attention_backward"]
    for row in more["rows"]:
        row["grok1_train_path_launches"] = grok[row["name"]]
    dist31 = distributed_phase(dev, gen, phase_done, card)
    for row, name in ((flash_row, "flash_attention"),
                      (train["row"], "flash_attention_backward"),
                      (ssd_row, "ssd_scan"),
                      (next(r for r in more["rows"]
                            if r["name"] == "ssd_scan_backward"),
                       "ssd_scan_backward")):
        row["dp_train_path_launches"] = dist31["dp_train_launches"][name]
    flash_row["gpipe_path_launches"] = dist31["gpipe_launches"]
    print("phase walls (s): " + ", ".join(
        f"[{n}] {w:.2f}" for n, w in sorted(walls.items()))
        + f"; sum {sum(walls.values()):.2f}", flush=True)
    print(json.dumps({"kernels": [matmul_row, flash_row, ssd_row, gmm_row,
                                  ln_row, cs_row, simt_row, gmm32_row,
                                  train["row"], *more["rows"],
                                  gemma["row"]],
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def flash_phases(dev, hw, gen, check, time_ms, phase_done) -> dict:
    """Phases 7-10: the flash-attention kernel, KLARAPTOR on it, the
    llama3.2-1b prefill step and the serving engine.  Returns the kernel's
    entry of the ``kernels`` line, and the driver, model and prefill inputs
    phase 21 reuses."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import (CudaEventTimer, Klaraptor,
                                  flash_attention_spec, flash_probe_data,
                                  selection_ratio)
    from repro_torch.core.kernel_spec import FLASH_HEAD_DIMS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_kernel, flash_attention_plain)
    from repro_torch.launch import build_engine, make_prefill_step
    from repro_torch.models import Model
    from repro_torch.serving import Request, greedy

    f32_tol = (2e-3, 1e-3)      # tests/test_kernels.py's flash tolerance

    # -- 7. the flash kernel against its plain version ------------------------
    print("[7] flash kernel vs plain (tolerance: bf16 2e-2 abs and rel; f32 "
          "2e-3 abs / 1e-3 rel, tests/test_kernels.py's flash tolerance; "
          f"S = {FLASH_SWEEP_S}, batch 2): every compiled wgmma tile (bf16, "
          "d 64, 128 and 256) and every feasible SIMT tile (f32)",
          flush=True)
    worst = 0.0
    n_checked = 0
    S = FLASH_SWEEP_S
    for dtype in (torch.bfloat16, torch.float32):
        for d in FLASH_HEAD_DIMS:
            for hq, hkv in ((8, 2), (4, 4)):        # GQA group 4 and 1
                for name, kw in FLASH_VARIANTS.items():
                    q, k, v = (
                        (torch.randn(2 * h, S, d, generator=gen, device=dev)
                         * 0.5).to(dtype) for h in (hq, hkv, hkv))
                    heads = dict(num_q_heads=hq, num_kv_heads=hkv)
                    plain = flash_attention_plain(q, k, v, **heads, **kw)
                    spec = flash_attention_spec(d, kw["causal"],
                                                q.element_size())
                    table = spec.candidates(
                        {"bh": 2 * hq, "sq": S, "skv": S}, hw)
                    errs = []
                    for i in range(len(table)):
                        P = table.row(i)
                        out = flash_attention_kernel(q, k, v, **P, **heads,
                                                     **kw)
                        errs.append(check(
                            out, plain, dtype, f"{dtype} d={d} {name} "
                            f"hq/hkv={hq}/{hkv} {P}", f32_tol, quiet=True))
                    n_checked += len(errs)
                    worst = max([worst] + errs)
                    body = "wgmma" if spec.compute_unit == "bf16" else "SIMT"
                    print(f"  {dtype} d={d} hq/hkv={hq}/{hkv} {name}: "
                          f"{len(errs)} {body} tiles, max_abs_err="
                          f"{max(errs):.3e} ok", flush=True)
    print(f"  {n_checked} kernel launches agree with the plain version")
    phase_done(7)

    # -- 8. KLARAPTOR for flash_attn_d64_causal (flash main path starts) ------
    LAUNCHES.reset()
    cfg = get_config("llama3.2-1b")
    spec = flash_attention_spec(cfg.head_dim, causal=True, dtype_bytes=2)
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    build = Klaraptor(timer).build_driver(
        spec, probe_data=flash_probe_data(), repeats=2,
        max_configs_per_size=12)
    cols = build.collected.columns
    print(f"[8] KLARAPTOR build on the card for {spec.name}")
    print("  " + build.fit_report().replace("\n", "\n  "))
    print(f"  probe sizes: bh <= {int(cols['bh'].max())}, sq = skv <= "
          f"{int(cols['sq'].max())}; probe executions "
          f"{build.collected.n_probe_executions}; probe device seconds "
          f"{build.probe_device_seconds:.4f}", flush=True)
    if int(cols["bh"].max()) > 64 or int(cols["sq"].max()) > 1024 \
            or not np.array_equal(cols["sq"], cols["skv"]):
        raise AssertionError("probes left bh <= 64, sq = skv <= 1024")
    D = {"bh": cfg.n_heads, "sq": PREFILL_S, "skv": PREFILL_S}
    chosen = build.driver.choose(D)
    print(f"  chosen at {D}: {chosen}; default {ops.FLASH_DEFAULT}")
    phase_done(8)

    # -- 9. the prefill step at full width ------------------------------------
    print(f"[9] llama3.2-1b prefill step, full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), B = 1, S = {PREFILL_S} (cut from prefill_32k's "
          f"32 x 32768), seeded random weights", flush=True)
    model = Model(cfg)
    params = model.init(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), generator=gen,
                           device=dev)
    step = make_prefill_step(model)
    torch.cuda.synchronize()
    before = LAUNCHES.count
    t0 = time.perf_counter()
    logits = step(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash_launches = LAUNCHES.count          # the flash main path ends here
    per_prefill = flash_launches - before
    print(f"  prefill wall {prefill_s * 1e3:.2f} ms (first call); flash "
          f"launches in the step: {per_prefill}; main-path launches "
          f"{flash_launches} (probes, probe warm-ups and the prefill)")
    if per_prefill != cfg.n_layers:
        raise AssertionError(f"the prefill launched the flash kernel "
                             f"{per_prefill} times, not {cfg.n_layers}")
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"prefill logits {logits.shape} not finite")

    recorded = []

    def plain_recording(q, k, v, **kw):
        recorded.append((q, k, v, kw))
        return flash_attention_plain(q, k, v, **kw)

    ref_logits = make_prefill_step(model, attn_op=plain_recording)(
        params, tokens)
    scale = float(ref_logits.abs().max())
    diff = float((logits - ref_logits).abs().max())
    agree = int(greedy(logits)[0]) == int(greedy(ref_logits)[0])
    print(f"  logits vs the plain-attention step: max|diff| {diff:.4e}, "
          f"max|logit| {scale:.4e}, ratio {diff / scale:.3e} (tol "
          f"{LOGIT_REL_TOL:g}); argmax agrees: {agree}", flush=True)
    if not diff <= LOGIT_REL_TOL * scale:
        raise AssertionError("tuned prefill logits disagree with plain")
    t0 = time.perf_counter()
    step(params, tokens)
    torch.cuda.synchronize()
    prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"  prefill wall {prefill_warm_ms:.2f} ms (second call)")
    profile = _device_profile(lambda: step(params, tokens),
                              "one prefill step")

    bq, bkv = chosen["bq"], chosen["bkv"]
    layers = []
    for li, (q, k, v, kw) in enumerate(recorded):
        heads = dict(num_q_heads=kw["num_q_heads"],
                     num_kv_heads=kw["num_kv_heads"])
        causal = kw["causal"]
        out = flash_attention_kernel(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                     **heads)
        plain = flash_attention_plain(q, k, v, causal=causal,
                                      q_chunk=cfg.attn_chunk, **heads)
        err = check(out, plain, q.dtype, f"layer {li}", quiet=True)
        worst = max(worst, err)
        q4 = q.view(1, heads["num_q_heads"], PREFILL_S, cfg.head_dim)
        k4 = k.view(1, heads["num_kv_heads"], PREFILL_S, cfg.head_dim)
        v4 = v.view(1, heads["num_kv_heads"], PREFILL_S, cfg.head_dim)
        bound, bound_by = _flash_bound_ms(
            q.shape[0], PREFILL_S, PREFILL_S, k.shape[0], cfg.head_dim,
            causal, q.element_size())
        r = {
            "layer": li, "config": chosen, "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention_kernel(
                q, k, v, bq=bq, bkv=bkv, causal=causal, **heads)),
            "default_ms": time_ms(lambda: flash_attention_kernel(
                q, k, v, causal=causal, **ops.FLASH_DEFAULT, **heads)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=True)),
            "plain_ms": time_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal, q_chunk=cfg.attn_chunk, **heads),
                max_iters=1),
            "bound_ms": bound, "bound_by": bound_by,
        }
        r["tflops"] = (4.0 * cfg.head_dim * q.shape[0] * PREFILL_S
                       * (PREFILL_S + 1) / 2) / (r["ms"] * 1e-3) / 1e12
        r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
        layers.append(r)
        print(f"  layer {li:2d}: kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s, {r['pct_of_bound']:.1f} % of "
              f"bound) | default {r['default_ms']:.4f} ms | bound "
              f"{r['bound_ms']:.4f} ms ({bound_by}) | SDPA "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x) "
              f"| plain {r['plain_ms']:.2f} ms | max_abs_err {err:.3e}",
              flush=True)
    del recorded, ref_logits
    torch.cuda.empty_cache()
    total = {key: sum(r[key] for r in layers)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                         "default_ms")}
    flops = sum(r["tflops"] * r["ms"] for r in layers)
    share = (profile["flash"] / profile["busy_ms"]) if profile else None
    print(f"  per prefill ({len(layers)} launches at {chosen}): kernel "
          f"{total['ms']:.3f} ms ({flops / total['ms']:.2f} TFLOP/s, "
          f"{100.0 * total['bound_ms'] / total['ms']:.1f} % of the bound "
          f"{total['bound_ms']:.4f} ms) | default {total['default_ms']:.3f} "
          f"ms | SDPA {total['library_ms']:.3f} ms "
          f"({total['ms'] / total['library_ms']:.2f}x) | plain "
          f"{total['plain_ms']:.2f} ms | flash share of the prefill's device "
          f"time: " + ("not measured" if share is None else f"{share:.1%}"),
          flush=True)

    ratio = selection_ratio(spec, timer, build.driver, D, hw)
    print(f"  [8, after the main path] selection ratio at {D} "
          f"(exhaustive: 1 warm-up + median of 3 timed launches per "
          f"candidate; printed, not gated): chosen {ratio['chosen']} "
          f"{ratio['chosen_time_s'] * 1e3:.4f} ms, best {ratio['best']} "
          f"{ratio['best_time_s'] * 1e3:.4f} ms of {ratio['n_configs']}, "
          f"ratio {ratio['ratio']:.3f}", flush=True)
    phase_done(9)

    # -- 10. the serving engine at full width ---------------------------------
    engine = build_engine(cfg, batch=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          params=params, seed=SEED)
    rng = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab_size,
                                            size=8 + 32 * i // 7)]
               for i in range(N_REQUESTS)]
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                              temperature=0.0 if i % 2 == 0 else 0.8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = engine.steps + sum(len(p) - 1 for p in prompts)
    produced = sum(len(r.output) for r in done)
    print(f"[10] serving engine, full width: {ENGINE_SLOTS} slots, max_seq "
          f"{ENGINE_MAX_SEQ}, {N_REQUESTS} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"max_new_tokens {MAX_NEW}, half greedy")
    print(f"  {len(done)} finished; {produced} tokens produced; {calls} "
          f"decode-step calls ({engine.steps} decode rounds, the rest "
          f"prompt tokens) in {wall:.2f} s: {wall / calls * 1e3:.2f} ms per "
          f"decode step (graphed)", flush=True)
    _print_captures(engine)
    if sorted(r.rid for r in done) != list(range(N_REQUESTS)) \
            or not all(r.done and 1 <= len(r.output) <= MAX_NEW
                       for r in done):
        raise AssertionError("not every request finished")
    if engine.compile_counts["decode_step"] != 1:
        raise AssertionError(f"compile_counts {engine.compile_counts}")
    tok = torch.tensor(engine.slot_last, device=dev)
    pos = torch.tensor(np.arange(ENGINE_SLOTS) + 64, device=dev,
                       dtype=torch.int32)

    def four_decode_steps():
        for _ in range(4):
            engine.model.decode_step(params, tok, pos, engine.cache)

    _device_profile(four_decode_steps, f"4 eager decode steps at batch "
                    f"{ENGINE_SLOTS}")
    for req in sorted(done, key=lambda r: r.rid):
        line = f"  request {req.rid}: prompt {len(req.prompt)}, " \
               f"{len(req.output)} tokens"
        if req.temperature <= 0.0:
            first = int(greedy(step(params, torch.tensor(
                [req.prompt], device=dev)))[0])
            line += (f"; first token {req.output[0]}, prefill argmax "
                     f"{first}, equal: {req.output[0] == first}")
        print(line)
    phase_done(10)

    ctx = {"spec": spec, "driver": build.driver, "cfg": cfg, "model": model,
           "params": params, "tokens": tokens,
           "launch_ms": total["ms"] / len(layers)}
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:95",
        "launches": flash_launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in layers) else "bytes",
        "library_ms": total["library_ms"],
        "default_ms": total["default_ms"],
        "redesigned": 16,
        "config": chosen,
        "selection_ratio": ratio["ratio"],
        "prefill_warm_ms": prefill_warm_ms,
        "prefill_flash_share": share,
        "layers": layers,
    }, ctx


def ssd_phases(dev, hw, gen, check, time_ms, phase_done) -> dict:
    """Phases 11-14: the SSD chunked-scan kernel, KLARAPTOR on it, the
    mamba2-130m prefill step and the serving engine.  Returns the kernel's
    entry of the ``kernels`` line, and the driver, model and prefill inputs
    phase 21 reuses."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (CudaEventTimer, Klaraptor, selection_ratio,
                                  ssd_probe_data, ssd_scan_spec)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_ctas,
                                              ssd_scan_kernel, ssd_scan_plain)
    from repro_torch.launch import build_engine, make_prefill_step
    from repro_torch.models import Model
    from repro_torch.serving import Request, greedy

    f32_tol = (5e-3, 1e-3)      # tests/test_kernels.py's SSD tolerance

    def inputs(bh, s, dh, n, dtype, dt_range, h):
        lo, hi = dt_range
        x = (torch.randn(bh, s, dh, generator=gen, device=dev) * 0.5
             ).to(dtype)
        dt = lo + (hi - lo) * torch.rand(bh, s, generator=gen, device=dev)
        B = (torch.randn(bh // h, s, n, generator=gen, device=dev) * 0.3
             ).to(dtype)
        C = (torch.randn(bh // h, s, n, generator=gen, device=dev) * 0.3
             ).to(dtype)
        A = -0.5 - torch.rand(bh, generator=gen, device=dev)
        return x, dt, B, C, A

    # -- 11. the SSD kernel against its plain version -------------------------
    print("[11] SSD kernel vs plain (tolerance: bf16 2e-2 abs and rel; f32 "
          "5e-3 abs / 1e-3 rel, tests/test_kernels.py's SSD tolerance; "
          f"bh 24 at S = {SSD_SWEEP_S} and {PREFILL_S}, B and C per head "
          "(h 1) and shared by 24 rows (h 24); A in [-1.5, -0.5])",
          flush=True)
    worst = 0.0
    n_checked = 0
    bh = 24
    for dtype in (torch.bfloat16, torch.float32):
        for dh, n in ((64, 128), (32, 32)):
            spec = ssd_scan_spec(dh, n, torch.finfo(dtype).bits // 8)
            for S in (SSD_SWEEP_S, PREFILL_S):
                chunks = spec.candidates({"bh": bh, "s": S, "chunkflops": 1},
                                         hw)["chunk"]
                for h, (name, rng) in itertools.product(
                        (1, bh), SSD_DT_RANGES.items()):
                    args = inputs(bh, S, dh, n, dtype, rng, h)
                    errs = []
                    for chunk in chunks.tolist():
                        out = ssd_scan_kernel(*args, chunk=chunk)
                        plain = ssd_scan_plain(*args, chunk=chunk)
                        errs.append(check(
                            out, plain, dtype, f"{dtype} h{dh} n{n} S={S} "
                            f"heads/group {h} {name} chunk {chunk}", f32_tol,
                            quiet=True))
                    n_checked += len(errs)
                    worst = max([worst] + errs)
                    print(f"  {dtype} h{dh} n{n} S={S} heads/group {h} "
                          f"{name}: chunks {chunks.tolist()}, "
                          f"max_abs_err={max(errs):.3e} ok", flush=True)
                    del args
    print(f"  {n_checked} kernel launches agree with the plain version")
    torch.cuda.empty_cache()
    phase_done(11)

    # -- 12. KLARAPTOR for ssd_scan_h64_n128 (SSD main path starts) ------------
    LAUNCHES.reset()
    cfg = get_config("mamba2-130m")
    dh, n, Hm = cfg.mamba_head_dim, cfg.ssm_state, cfg.mamba_heads
    spec = ssd_scan_spec(dh, n, dtype_bytes=2)
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    build = Klaraptor(timer).build_driver(spec, probe_data=ssd_probe_data(),
                                          repeats=2)
    cols = build.collected.columns
    print(f"[12] KLARAPTOR build on the card for {spec.name}")
    print("  " + build.fit_report().replace("\n", "\n  "))
    print(f"  probe sizes: bh <= {int(cols['bh'].max())}, s <= "
          f"{int(cols['s'].max())}; probe executions "
          f"{build.collected.n_probe_executions}; probe device seconds "
          f"{build.probe_device_seconds:.4f}", flush=True)
    if int(cols["bh"].max()) > 64 or int(cols["s"].max()) > 2048:
        raise AssertionError("probes left bh <= 64, s <= 2048")
    D = {"bh": Hm, "s": PREFILL_S, "chunkflops": 1}
    chosen = build.driver.choose(D)
    print(f"  chosen at {D}: {chosen}; default {ops.SSD_DEFAULT}")
    phase_done(12)

    # -- 13. the prefill step at full width ------------------------------------
    print(f"[13] mamba2-130m prefill step, full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, d_inner {cfg.mamba_d_inner}, "
          f"{Hm} SSM heads of {dh}, state {n}, conv {cfg.conv_kernel}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}), B = 1, S = {PREFILL_S} "
          f"(cut from prefill_32k's 32 x 32768), seeded random weights",
          flush=True)
    model = Model(cfg)
    params = model.init(SEED)
    print(f"  parameters: {model.param_count()}")
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), generator=gen,
                           device=dev)
    step = make_prefill_step(model)
    torch.cuda.synchronize()
    before = LAUNCHES.count
    t0 = time.perf_counter()
    logits = step(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ssd_launches = LAUNCHES.count            # the SSD main path ends here
    per_prefill = ssd_launches - before
    print(f"  prefill wall {prefill_s * 1e3:.2f} ms (first call); SSD "
          f"launches in the step: {per_prefill}; main-path launches "
          f"{ssd_launches} (probes, probe warm-ups and the prefill)")
    if per_prefill != cfg.n_layers:
        raise AssertionError(f"the prefill launched the SSD kernel "
                             f"{per_prefill} times, not {cfg.n_layers}")
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"prefill logits {logits.shape} not finite")

    recorded = []
    chunk, dflt = chosen["chunk"], ops.SSD_DEFAULT["chunk"]

    def plain_recording(x, dt, B, C, A):
        # the plain version at the kernel's chunk: the same function, summed
        # in another order
        recorded.append((x, dt, B, C, A))
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk)

    ref_logits = make_prefill_step(model, ssd_op=plain_recording)(
        params, tokens)
    other = dflt if dflt != chunk else chunk // 2
    floor_logits = make_prefill_step(model, ssd_op=functools.partial(
        ssd_scan_plain, chunk=other))(params, tokens)
    # the padded vocab columns (50280 of 50432 are real) hold -1e30
    V = cfg.vocab_size

    def compare(a, b) -> tuple[float, float, bool]:
        scale = float(b[:, :V].abs().max())
        diff = float((a - b)[:, :V].abs().max())
        return diff, scale, int(greedy(a)[0]) == int(greedy(b)[0])

    diff, scale, agree = compare(logits, ref_logits)
    fdiff, fscale, fagree = compare(floor_logits, ref_logits)
    print(f"  bf16 logits vs the plain-SSD step: max|diff| {diff:.4e}, "
          f"max|logit| {scale:.4e}, ratio {diff / scale:.3e}, argmax "
          f"agrees: {agree}; bf16 floor, the plain SSD at chunk {other} "
          f"vs {chunk}: ratio {fdiff / fscale:.3e}, argmax agrees: "
          f"{fagree} (printed, not gated)", flush=True)
    del ref_logits, floor_logits

    # The same step on the same weights in f32: the gate.
    cfg32 = cfg.replace(dtype=torch.float32)
    model32 = Model(cfg32)
    params32 = _upcast(params)
    step32 = make_prefill_step(model32)
    chunk32 = ops._ssd_chunk(dh, n, 4, chunk)
    before = LAUNCHES.count
    logits32 = step32(params32, tokens)
    torch.cuda.synchronize()
    if LAUNCHES.count - before != cfg.n_layers:
        raise AssertionError("the f32 prefill did not launch the SSD kernel "
                             "once per layer")
    ref32 = make_prefill_step(model32, ssd_op=functools.partial(
        ssd_scan_plain, chunk=chunk32))(params32, tokens)
    diff, scale, agree = compare(logits32, ref32)
    print(f"  f32 logits vs the plain-SSD step (chunk {chunk32}): max|diff| "
          f"{diff:.4e}, max|logit| {scale:.4e}, ratio {diff / scale:.3e} "
          f"(tol {SSD_LOGIT_REL_TOL:g}); argmax agrees: {agree}", flush=True)
    if not diff <= SSD_LOGIT_REL_TOL * scale:
        raise AssertionError("tuned prefill logits disagree with plain")
    del logits32, ref32
    t0 = time.perf_counter()
    step(params, tokens)
    torch.cuda.synchronize()
    print(f"  prefill wall {(time.perf_counter() - t0) * 1e3:.2f} ms "
          f"(second call)")
    _device_profile(lambda: step(params, tokens), "one prefill step",
                    groups=SSD_PROFILE_GROUPS)

    dflt = ops._ssd_chunk(dh, n, 2, dflt)
    ctas = ssd_ctas(Hm, PREFILL_S, dh, n, chunk, torch.bfloat16)
    print(f"  one launch at B = 1, chunk {chunk}: {ctas} CTAs of "
          f"{2 * chunk} threads on {hw.sm_count} SMs, chains of "
          f"{-(-PREFILL_S // chunk)} chunk states; default chunk {dflt} "
          f"(the reference's {ops.SSD_DEFAULT['chunk']}, fitted to the "
          f"compiled chunks)")
    layers = []
    for li, args in enumerate(recorded):
        if tuple(args[2].shape) != (1, PREFILL_S, n):
            raise AssertionError(f"layer {li} handed the SSD B of shape "
                                 f"{tuple(args[2].shape)}, not one per "
                                 f"group")
        out = ssd_scan_kernel(*args, chunk=chunk)
        plain = ssd_scan_plain(*args, chunk=chunk)
        err = check(out, plain, args[0].dtype, f"layer {li}", quiet=True)
        worst = max(worst, err)
        elem = args[0].element_size()
        bound, bound_by = _ssd_bound_ms(Hm, PREFILL_S, dh, n, chunk, elem, 1)
        per_head, _ = _ssd_bound_ms(Hm, PREFILL_S, dh, n, chunk, elem, Hm)
        r = {
            "layer": li, "config": chosen, "max_abs_err": err,
            "ms": time_ms(lambda: ssd_scan_kernel(*args, chunk=chunk)),
            "default_ms": time_ms(lambda: ssd_scan_kernel(*args,
                                                          chunk=dflt)),
            "plain_ms": time_ms(lambda: ssd_scan_plain(*args, chunk=chunk),
                                max_iters=1),
            "bound_ms": bound, "bound_by": bound_by,
            "bound_per_head_ms": per_head, "ctas": ctas,
        }
        r["pct_of_bound"] = 100.0 * bound / r["ms"]
        r["gb_s"] = (Hm * PREFILL_S * 2 * dh * 2 + PREFILL_S * 2 * n * 2) \
            / (r["ms"] * 1e-3) / 1e9
        layers.append(r)
        print(f"  layer {li:2d}: kernel {r['ms']:.4f} ms ({r['gb_s']:.1f} "
              f"GB/s, {r['pct_of_bound']:.1f} % of bound) | default "
              f"{r['default_ms']:.4f} ms | bound {bound:.4f} ms "
              f"({bound_by}; {per_head:.4f} with B and C per head) | "
              f"plain {r['plain_ms']:.2f} ms | max_abs_err {err:.3e}",
              flush=True)
    # the chunk's trade at the prefill shape: s / chunk hops of the chain
    # of states against quadratic work per chunk
    sweep = {c: time_ms(lambda: ssd_scan_kernel(*recorded[0], chunk=c))
             for c in spec.candidates(D, hw)["chunk"].tolist()}
    print("  layer 0 at every compiled chunk: " + ", ".join(
        f"chunk {c} ({ssd_ctas(Hm, PREFILL_S, dh, n, c, torch.bfloat16)} "
        f"CTAs, {-(-PREFILL_S // c)} chain hops) {t:.4f} ms"
        for c, t in sweep.items()), flush=True)
    del recorded
    torch.cuda.empty_cache()

    ratio = selection_ratio(spec, timer, build.driver, D, hw)
    print(f"  [12, after the main path] selection ratio at {D} "
          f"(exhaustive: 1 warm-up + median of 3 timed launches per "
          f"candidate; printed, not gated): chosen {ratio['chosen']} "
          f"{ratio['chosen_time_s'] * 1e3:.4f} ms, best {ratio['best']} "
          f"{ratio['best_time_s'] * 1e3:.4f} ms of {ratio['n_configs']}, "
          f"ratio {ratio['ratio']:.3f}", flush=True)
    phase_done(13)

    # -- 14. the serving engine at full width ---------------------------------
    engine = build_engine(cfg, batch=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          params=params, seed=SEED)
    rng = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab_size,
                                            size=8 + 32 * i // 7)]
               for i in range(N_REQUESTS)]
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                              temperature=0.0 if i % 2 == 0 else 0.8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = engine.steps + sum(len(p) - 1 for p in prompts)
    produced = sum(len(r.output) for r in done)
    print(f"[14] serving engine, mamba2-130m full width: {ENGINE_SLOTS} "
          f"slots, max_seq {ENGINE_MAX_SEQ}, {N_REQUESTS} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"max_new_tokens {MAX_NEW}, half greedy")
    print(f"  {len(done)} finished; {produced} tokens produced; {calls} "
          f"decode-step calls ({engine.steps} decode rounds, the rest "
          f"prompt tokens) in {wall:.2f} s: {wall / calls * 1e3:.2f} ms per "
          f"decode step (graphed)", flush=True)
    _print_captures(engine)
    if sorted(r.rid for r in done) != list(range(N_REQUESTS)) \
            or not all(r.done and 1 <= len(r.output) <= MAX_NEW
                       for r in done):
        raise AssertionError("not every request finished")
    if engine.compile_counts["decode_step"] != 1:
        raise AssertionError(f"compile_counts {engine.compile_counts}")
    tok = torch.tensor(engine.slot_last, device=dev)
    pos = torch.tensor(np.arange(ENGINE_SLOTS) + 64, device=dev,
                       dtype=torch.int32)

    def four_decode_steps():
        for _ in range(4):
            engine.model.decode_step(params, tok, pos, engine.cache)

    _device_profile(four_decode_steps, f"4 eager decode steps at batch "
                    f"{ENGINE_SLOTS}", groups=SSD_PROFILE_GROUPS)
    # The engines step every slot to feed one slot's prompt and never reset a
    # freed slot, so a Mamba-2 block's state leaks between slots and requests
    # (as in the JAX engine).  Only the first request of a batch-1 engine
    # starts from a clean state: there the decode path (an f32 recurrence,
    # token by token) and the prefill step (the chunked scan) compute the same
    # function, so the first token must equal the prefill argmax or score
    # within the logit gate of it.  The gate holds in f32 (see
    # SSD_LOGIT_REL_TOL); bf16 is printed.
    for what, c, prm, stp in (("bf16", cfg, params, step),
                              ("f32", cfg32, params32, step32)):
        solo = build_engine(c, batch=1, max_seq=ENGINE_MAX_SEQ, params=prm,
                            seed=SEED)
        solo.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=4))
        first = solo.run()[0].output[0]
        pre = stp(prm, torch.tensor([prompts[0]], device=dev))[0, :V]
        arg = int(greedy(pre[None])[0])
        gap = float(pre[arg] - pre[first])
        pre_scale = float(pre.abs().max())
        top = torch.topk(pre, 2)
        print(f"  {what} batch-1 engine, first request (prompt "
              f"{len(prompts[0])}): first token {first}, prefill argmax "
              f"{arg} (top-2 logits {top.values.tolist()}), equal: "
              f"{first == arg}; logit gap {gap:.4e}, max|logit| "
              f"{pre_scale:.4e}")
    if not (first == arg or gap <= SSD_LOGIT_REL_TOL * pre_scale):
        raise AssertionError("the engine's first token disagrees with the "
                             "prefill step")
    for req in sorted(done, key=lambda r: r.rid):
        print(f"  request {req.rid}: prompt {len(req.prompt)}, "
              f"{len(req.output)} tokens, temperature {req.temperature}")
    phase_done(14)

    total = {key: sum(r[key] for r in layers)
             for key in ("ms", "plain_ms", "bound_ms", "default_ms",
                         "bound_per_head_ms")}
    print(f"  per prefill: kernel {total['ms']:.4f} ms, default chunk "
          f"{total['default_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"({100.0 * total['bound_ms'] / total['ms']:.1f} %; "
          f"{total['bound_per_head_ms']:.4f} ms with B and C per head), "
          f"plain {total['plain_ms']:.2f} ms, chunk {chunk}, {ctas} CTAs, "
          f"selection ratio {ratio['ratio']:.3f}", flush=True)
    ctx = {"spec": spec, "driver": build.driver, "cfg": cfg, "model": model,
           "params": params, "tokens": tokens}
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:85",
        "launches": ssd_launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in layers) else "bytes",
        "library_ms": None,   # no single PyTorch call computes the SSD
        "default_ms": total["default_ms"],
        "bound_per_head_ms": total["bound_per_head_ms"],
        "config": chosen,
        "selection_ratio": ratio["ratio"],
        "chunk_sweep_ms": sweep,
        "layers": layers,
    }, ctx


def gmm_phases(dev, hw, gen, check, time_ms,
               phase_done) -> tuple[dict, dict, dict]:
    """Phases 15-16: the grouped-matmul kernel and KLARAPTOR on it, bf16
    and f32.  Returns the f32 and the bf16 entries of the ``kernels``
    line, the bf16 spec, driver and timer phase 22 reuses, and the f32
    exhaustive pass phase 25 reuses."""
    import numpy as np
    import torch

    from repro_torch.core import (CudaEventTimer, Klaraptor, exhaustive_pass,
                                  gmm_probe_data, moe_gmm_spec,
                                  selection_ratio)
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (LAUNCHES, moe_gmm_kernel,
                                             moe_gmm_plain)

    def inputs(e, g, k, n, dtype):
        x = torch.randn(e, g, k, generator=gen, device=dev).to(dtype)
        w = (torch.randn(e, k, n, generator=gen, device=dev) / k ** 0.5
             ).to(dtype)
        return x, w

    # -- 15. the grouped-matmul kernel against its plain version --------------
    print("[15] grouped-matmul kernel vs plain (tolerance: 2e-2 bf16, 2e-4 "
          "f32, atol=rtol, the repo's kernel-test tolerances)", flush=True)
    worst = worst32 = 0.0
    n_checked = 0
    D = {"e": 4, "g": 256, "k": 1024, "n": 512}   # the rings wrap
    for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        table = moe_gmm_spec(nbytes).candidates(D, hw)
        x, w = inputs(D["e"], D["g"], D["k"], D["n"], dtype)
        plain = moe_gmm_plain(x, w)
        errs = [check(moe_gmm_kernel(x, w, **table.row(i)), plain, dtype,
                      f"{dtype} {D} {table.row(i)}", quiet=True)
                for i in range(len(table))]
        if dtype == torch.float32:      # and each tile at k = bk: one k step
            for i in range(len(table)):
                P = table.row(i)
                xs = x[:, :, :P["bk"]].contiguous()
                ws = w[:, :P["bk"]].contiguous()
                errs.append(check(moe_gmm_kernel(xs, ws, **P),
                                  moe_gmm_plain(xs, ws), dtype,
                                  f"f32 k = bk {P}", quiet=True))
        n_checked += len(errs)
        if dtype == torch.float32:
            worst32 = max([worst32] + errs)
        else:
            worst = max([worst] + errs)
        print(f"  {dtype} {D}: {len(table)} feasible tiles"
              f"{' (and each at k = bk)' if dtype == torch.float32 else ''}"
              f", max_abs_err={max(errs):.3e} ok", flush=True)
        xu, wu = inputs(3, 100, 77, 50, dtype)
        err = check(ops.moe_gmm(xu, wu), moe_gmm_plain(xu, wu), dtype,
                    f"{dtype} ops.moe_gmm at the unaligned (e, g, k, n) "
                    f"(3, 100, 77, 50)")
        if dtype == torch.float32:
            worst32 = max(worst32, err)
        else:
            worst = max(worst, err)
    print(f"  {n_checked} sweep launches agree with the plain version")
    phase_done(15)

    # -- 16. KLARAPTOR for moe_gmm_b16 (the grouped-matmul main path) ---------
    LAUNCHES.reset()
    spec = moe_gmm_spec(dtype_bytes=2)
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    build = Klaraptor(timer).build_driver(
        spec, probe_data=gmm_probe_data(), repeats=2,
        max_configs_per_size=24)
    cols = build.collected.columns
    print(f"[16] KLARAPTOR build on the card for {spec.name}")
    print("  " + build.fit_report().replace("\n", "\n  "))
    print(f"  probe sizes: e <= {int(cols['e'].max())}, g, k, n <= "
          f"{max(int(cols[d].max()) for d in 'gkn')}; probe executions "
          f"{build.collected.n_probe_executions}; probe device seconds "
          f"{build.probe_device_seconds:.4f}", flush=True)
    if int(cols["e"].max()) > 4 or \
            max(int(cols[d].max()) for d in "gkn") > 1024:
        raise AssertionError("probes left e <= 4, g, k, n <= 1024")
    kept = {}
    for name, k, n in GMM_SHAPES:
        x, w = inputs(GMM_E, GMM_G, k, n, torch.bfloat16)
        before = LAUNCHES.count
        out = ops.moe_gmm(x, w)
        if LAUNCHES.count != before + 1:
            raise AssertionError(f"{name}: ops.moe_gmm launched "
                                 f"{LAUNCHES.count - before} kernels, not 1")
        if tuple(out.shape) != (GMM_E, GMM_G, n) \
                or out.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: output {out.shape} {out.dtype}")
        kept[name] = (x, w, out)
    launches = LAUNCHES.count           # the grouped-matmul main path ends
    print(f"  main-path launches: {launches} (probes, probe warm-ups and "
          f"the tuned calls)")
    rows = []
    for name, k, n in GMM_SHAPES:
        x, w, out = kept.pop(name)
        Dn = {"e": GMM_E, "g": GMM_G, "k": k, "n": n}
        cfg = build.driver.choose(Dn)
        dflt = ops._fit_gemm("moe_gmm_b16", ops.GMM_DEFAULT,
                             {"bg": GMM_G, "bn": n, "bk": k})
        plain = moe_gmm_plain(x, w)
        err = check(out, plain, torch.bfloat16,
                    f"{name} {Dn} tuned {cfg} vs plain")
        worst = max(worst, err)
        flops = 2.0 * GMM_E * GMM_G * k * n
        t_ops = flops / PEAK_BF16
        t_bytes = GMM_E * (GMM_G * k + k * n + GMM_G * n) * 2 / HBM_BW
        r = {
            "shape": name, **Dn, "config": cfg, "max_abs_err": err,
            "default": dflt,
            "ms": time_ms(lambda: moe_gmm_kernel(x, w, **cfg)),
            "default_ms": time_ms(lambda: moe_gmm_kernel(x, w, **dflt)),
            "library_ms": time_ms(lambda: torch.bmm(x, w)),
            "plain_ms": time_ms(lambda: moe_gmm_plain(x, w), max_iters=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
        rows.append(r)
        print(f"  {name} {Dn}: chosen {cfg} {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s, {r['pct_of_bound']:.1f} % of "
              f"bound) | default {dflt} {r['default_ms']:.4f} ms | "
              f"torch.bmm {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x) | plain "
              f"{r['plain_ms']:.2f} ms | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
        del x, w, out, plain
        torch.cuda.empty_cache()
    for r in rows:
        Dn = {d: r[d] for d in ("e", "g", "k", "n")}
        t0 = time.perf_counter()
        ratio = selection_ratio(spec, timer, build.driver, Dn, hw)
        r["selection_ratio"] = ratio["ratio"]
        print(f"  [16, after the main path] selection ratio at {Dn} "
              f"(exhaustive: 1 warm-up + median of 3 timed launches per "
              f"candidate; printed, not gated): chosen {ratio['chosen']} "
              f"{ratio['chosen_time_s'] * 1e3:.4f} ms, best {ratio['best']} "
              f"{ratio['best_time_s'] * 1e3:.4f} ms of {ratio['n_configs']}, "
              f"ratio {ratio['ratio']:.3f} ({time.perf_counter() - t0:.1f} "
              f"s)", flush=True)
        torch.cuda.empty_cache()
    # -- 16 (f32). KLARAPTOR for moe_gmm_b32 (the f32 grouped matmul) -----
    LAUNCHES.reset()
    spec32 = moe_gmm_spec(dtype_bytes=4)
    build32 = Klaraptor(timer).build_driver(
        spec32, probe_data=gmm_probe_data(), repeats=2,
        max_configs_per_size=24)
    name, k, n = GMM_SHAPES[0]
    Dn = {"e": GMM_E, "g": GMM_G, "k": k, "n": n}
    x, w = inputs(GMM_E, GMM_G, k, n, torch.float32)
    before = LAUNCHES.count
    out = ops.moe_gmm(x, w)
    if LAUNCHES.count != before + 1 or out.dtype != torch.float32:
        raise AssertionError("ops.moe_gmm on f32 did not launch the kernel")
    launches32 = LAUNCHES.count      # the f32 grouped matmul's path ends
    cfg = build32.driver.choose(Dn)
    plain = moe_gmm_plain(x, w)
    err32 = check(out, plain, torch.float32,
                  f"f32 {name} {Dn} tuned {cfg} vs plain")
    flops = 2.0 * GMM_E * GMM_G * k * n
    t_ops = flops / PEAK_F32
    t_bytes = GMM_E * (GMM_G * k + k * n + GMM_G * n) * 4 / HBM_BW
    r32 = {
        "shape": f"{name} f32", **Dn, "config": cfg,
        "ms": time_ms(lambda: moe_gmm_kernel(x, w, **cfg)),
        "library_ms": time_ms(lambda: torch.bmm(x, w)),
        "plain_ms": time_ms(lambda: moe_gmm_plain(x, w), max_iters=1),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    r32["tflops"] = flops / (r32["ms"] * 1e-3) / 1e12
    r32["pct_of_bound"] = 100.0 * r32["bound_ms"] / r32["ms"]
    print(f"[16, f32] KLARAPTOR build on the card for {spec32.name}, then "
          f"ops.moe_gmm in f32 at {Dn}: main-path launches {launches32} "
          f"(probes, warm-ups, the tuned call); chosen {cfg} "
          f"{r32['ms']:.4f} ms ({r32['tflops']:.2f} TFLOP/s, "
          f"{r32['pct_of_bound']:.1f} % of the FP32 bound "
          f"{r32['bound_ms']:.4f} ms, {r32['bound_by']}) | torch.bmm f32, "
          f"TF32 off {r32['library_ms']:.4f} ms "
          f"({r32['ms'] / r32['library_ms']:.2f}x) | plain "
          f"{r32['plain_ms']:.2f} ms", flush=True)
    del x, w, out, plain
    torch.cuda.empty_cache()
    # the f32 driver's choice against every feasible tile on the card (its
    # choice moved between runs); phase 25 searches on this same pass
    t0 = time.perf_counter()
    table32, times32 = exhaustive_pass(spec32, timer, Dn, hw)
    best = int(np.argmin(times32))
    i = next(j for j in range(len(table32)) if table32.row(j) == cfg)
    r32["selection_ratio"] = float(times32[best] / times32[i])
    print(f"  [16, f32, after the main path] selection ratio at {Dn} "
          f"(exhaustive: 1 warm-up + median of 3 timed launches per "
          f"candidate; printed, not gated): chosen {cfg} "
          f"{times32[i] * 1e3:.4f} ms, best {table32.row(best)} "
          f"{times32[best] * 1e3:.4f} ms of {len(table32)}, ratio "
          f"{r32['selection_ratio']:.3f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    phase_done(16)
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                         "default_ms")}
    gmm32_row = {
        "name": "moe_gmm_b32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:46",
        "launches": launches32,
        "max_abs_err": max(err32, worst32),
        **{key: r32[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "shapes": [r32],
    }
    return gmm32_row, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:46",
        "launches": launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in rows) else "bytes",
        "library_ms": total["library_ms"],
        "default_ms": total["default_ms"],
        "shapes": rows,
    }, {"spec": spec, "driver": build.driver, "timer": timer,
        "f32_pass": (table32, times32)}


def introspect_phase(hw, phase_done) -> None:
    """Phase 17: specs derived from the compiled kernels on the card."""
    from repro_torch.core import HopperModel, Klaraptor, gmm_probe_data
    from repro_torch.introspect import derive_kernel
    from repro_torch.introspect.tier1 import EQUIV_SHAPES, tier1_pairs
    from repro_torch.kernels.layernorm import LAYERNORM, layernorm_grid_spec
    from repro_torch.kernels.reduce import COLSUM, colsum_grid_spec

    print("[17] introspection on the card: specs derived from the launch "
          "descriptions and the compiled kernels", flush=True)

    def show(spec, cap) -> None:
        axes = ", ".join(
            f"{a.name}={a.data}" + (f"/{a.block}" if a.block else "")
            + (" (loop)" if a.sequential else "")
            + (" (ragged)" if a.ragged else "") for a in spec.grid)
        print(f"  {spec.name}: grid [{axes}]; threads "
              f"{spec.threads.to_source()}; "
              f"flops/point {spec.flops_per_point}")
        for op in spec.operands:
            kind = ("scratch" if op.scratch else "output" if op.is_output
                    else "staged" if op.staged else "input")
            print(f"    {op.name}: tile {op.tile} deps {op.deps} "
                  f"{op.dtype_bytes} B/elem, {kind}")
        print(f"    constraints {list(spec.constraints)}")
        print(f"    registers {cap.num_regs} ({cap.attributes_source}) "
              f"against the launch-bounds cap {cap.regs_cap}; spilled local "
              f"bytes {cap.local_bytes}; fingerprint {cap.fingerprint}",
              flush=True)
        if cap.attributes_source != "compiled" or \
                cap.num_regs > cap.regs_cap:
            raise AssertionError(f"{spec.name}: registers {cap.num_regs} "
                                 f"({cap.attributes_source})")

    for kernel, gs in ((LAYERNORM, layernorm_grid_spec(AUTO_D_MODEL)),
                       (COLSUM, colsum_grid_spec())):
        spec, cap = derive_kernel(kernel, gs)
        show(spec, cap)
        if spec.name.startswith("layernorm"):
            if [op.deps for op in spec.operands[2:4]] != [(), ()]:
                raise AssertionError("gamma and beta are not resident")
        else:
            cols, rows = (a.name for a in spec.grid)
            deps = [op.deps for op in spec.operands[:4]]
            if deps != [(cols, rows)] * 3 + [(cols,)] \
                    or any(a.sequential for a in spec.grid):
                raise AssertionError(
                    f"the column sum's derived launch is not the row-split "
                    f"grid (partials per CTA, the output once per column "
                    f"block): {deps}")
    for kernel, gs, hand in tier1_pairs():
        spec, cap = derive_kernel(kernel, gs)
        show(spec, cap)
        probes = gmm_probe_data() if hand.name.startswith("moe") else None
        drivers = [Klaraptor(HopperModel(hw, noise=0.03, seed=3)
                             ).build_driver(s, probe_data=probes, repeats=2,
                                            max_configs_per_size=12,
                                            register=False).driver
                   for s in (hand, spec)]
        same = [drivers[0].choose(D) == drivers[1].choose(D)
                for D in EQUIV_SHAPES[hand.name]]
        print(f"    drivers from the hand spec (registers "
              f"{hand.regs_per_thread}) and the derived one (registers "
              f"{spec.regs_per_thread}) on HopperModel choose the same "
              f"config at {sum(same)} of {len(same)} shapes", flush=True)
        if not all(same):
            raise AssertionError(f"{hand.name}: derived and hand specs "
                                 f"choose differently")
    phase_done(17)


def _layernorm_table(ak, hw) -> dict:
    """Phase 18's record of the layernorm's choice: the fit's errors, the
    probe rows it saw, and at each probe size and each chosen-for size one
    line per br candidate with the card's time as the timer takes it (a
    warm-up, then the median of 7 launches, each after the L2 flush), the
    same without the flush (the timer before it: each launch finds the
    previous one's inputs and output in the L2), the driver's predicted
    time, and the launch's CTAs and blocks resident per SM.  Returns and
    prints as one JSON line {"cold": {r: {br: us}}, "no_flush": ...}."""
    import numpy as np

    from repro_torch.core import CudaEventTimer, registry

    class NoFlush(CudaEventTimer):
        def _flush_l2(self) -> None:
            pass

    build, drv = ak.build, registry.get(ak.name)
    print(f"  {ak.name}: " + build.fit_report().replace("\n", "\n    "))
    cols = build.collected.columns
    total = build.collected.metrics["total_time_s"]
    order = np.lexsort((cols["br"], cols["r"]))
    print("    probe rows (r, br, measured us): " + ", ".join(
        f"({int(cols['r'][i])}, {int(cols['br'][i])}, {total[i] * 1e6:.2f})"
        for i in order))
    timers = {"cold": CudaEventTimer(hw, warmup=1, timings=7, seed=SEED),
              "no_flush": NoFlush(hw, warmup=1, timings=7, seed=SEED)}
    recorded = {key: {} for key in timers}
    for r in sorted(set(int(x) for x in cols["r"]) | set(LN_ROWS)):
        D = {"r": r}
        table = ak.spec.candidates(D, hw)
        tt = ak.spec.traffic_table(D, table, hw)
        card = {key: t.true_time_batch(tt) for key, t in timers.items()}
        est = drv.estimate_batch(D, {p: table[p]
                                     for p in ak.spec.program_params})
        chosen = drv.choose(D)["br"]
        best = int(table["br"][int(np.argmin(card["cold"]))])
        for key in timers:
            recorded[key][r] = {}
        for i in range(len(table)):
            br = int(table["br"][i])
            for key in timers:
                recorded[key][r][br] = round(float(card[key][i]) * 1e6, 3)
            print(f"    r {r} br {br:4d}: card {card['cold'][i] * 1e6:8.2f} "
                  f"us | without the flush {card['no_flush'][i] * 1e6:8.2f} "
                  f"us | predicted {est[i] * 1e6:8.2f} us | CTAs "
                  f"{int(tt.ctas[i])} resident {int(tt.blocks_resident[i])}"
                  + (" | chosen" if br == chosen else "")
                  + (" | card best" if br == best else ""))
    print("    layernorm card us by r and br: " + json.dumps(recorded),
          flush=True)
    return recorded


def auto_phases(dev, hw, gen, check, time_ms, phase_done, caches):
    """Phases 18-19: the auto-specced layernorm and column sum, tuned on
    the card and launched through the ops and the serving entry point.
    Returns the two kernels' entries of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import CudaEventTimer, registry, selection_ratio
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce as cs
    from repro_torch.launch import build_auto_kernels
    from repro_torch.launch import serve

    # -- 18. the auto path (the layernorm and column-sum main path) -----------
    ln.LAUNCHES.reset()
    cs.LAUNCHES.reset()
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    t0 = time.perf_counter()
    kernels = build_auto_kernels(d_model=AUTO_D_MODEL, tune_device=timer)
    print(f"[18] the auto path: build_auto_kernels(d_model={AUTO_D_MODEL}) "
          f"introspected and tuned {[ak.name for ak in kernels]} on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    ak_ln, ak_cs = kernels
    c = AUTO_D_MODEL
    calls = []
    for r in LN_ROWS:
        x, res = (torch.randn(r, c, generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(2))
        g, b = (torch.randn(c, generator=gen, device=dev) for _ in range(2))
        before = ln.LAUNCHES.count
        out = ops.layernorm(x, res, g, b)
        if ln.LAUNCHES.count != before + 1:
            raise AssertionError("ops.layernorm did not launch the kernel "
                                 "once")
        calls.append(("layernorm", {"r": r}, (x, res, g, b), out))
    for r, cc in COLSUM_SHAPES:
        x = torch.randn(r, cc, generator=gen, device=dev).to(torch.bfloat16)
        before = cs.LAUNCHES.count
        out = ops.blocked_colsum(x)
        if cs.LAUNCHES.count != before + 1:
            raise AssertionError("ops.blocked_colsum did not launch the "
                                 "kernel once")
        calls.append(("colsum", {"r": r, "c": cc}, (x,), out))
    launches = {"layernorm": ln.LAUNCHES.count,      # the main path ends
                "colsum": cs.LAUNCHES.count}
    print(f"  main-path launches: layernorm {launches['layernorm']}, colsum "
          f"{launches['colsum']} (probes, probe warm-ups and the tuned "
          f"calls)")
    _layernorm_table(ak_ln, hw)
    rows = {"layernorm": [], "colsum": []}
    for kind, Dn, args, out in calls:
        ak = ak_ln if kind == "layernorm" else ak_cs
        cfg = ak.fit_config(ak.choose(Dn), Dn)
        dflt = ak.fit_config(ak.defaults, Dn)
        if kind == "layernorm":
            x, res, g, b = args
            r = Dn["r"]
            if -(-r // cfg["br"]) < 2:
                raise AssertionError(f"layernorm at r {r} runs br "
                                     f"{cfg['br']}: one CTA")
            plain = ln.layernorm_plain(x, res, g, b)
            kern = functools.partial(ln.layernorm_kernel, x, res, g, b)
            plain_fn = functools.partial(ln.layernorm_plain, x, res, g, b)

            def library(x=x, g=g, b=b):
                return F.layer_norm(x, (c,), g.to(x.dtype), b.to(x.dtype),
                                    1e-6)

            nbytes = 3 * r * c * 2 + 2 * c * 4
            flops = ln.LN_FLOPS_PER_ELEMENT * r * c
            lib_name = "F.layer_norm (no residual add)"
        else:
            (x,) = args
            plain = cs.colsum_plain(x)
            kern = functools.partial(cs.colsum_kernel, x)
            plain_fn = functools.partial(cs.colsum_plain, x)

            def library(x=x):
                return torch.sum(x, 0, dtype=torch.float32)

            nbytes = Dn["r"] * Dn["c"] * 2 + Dn["c"] * 4
            flops = Dn["r"] * Dn["c"]
            lib_name = "torch.sum"
        err = check(out, plain, torch.bfloat16, f"{kind} {Dn} tuned {cfg}")
        extra = {}
        if kind == "colsum":
            again = kern(**cfg)
            if not torch.equal(again, kern(**cfg)) or \
                    not torch.equal(again, out):
                raise AssertionError(f"colsum {Dn}: two calls on one input "
                                     f"differ")
            extra["workspace_bytes"] = Dn["r"] // cfg["br"] * Dn["c"] * 4
            extra["ctas"] = (Dn["c"] // cfg["bc"]) * (Dn["r"] // cfg["br"])
        t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM_BW
        row = {
            "shape": Dn, "config": cfg, "default": dflt, "max_abs_err": err,
            "ms": time_ms(lambda: kern(**cfg)),
            "default_ms": time_ms(lambda: kern(**dflt)),
            "library_ms": time_ms(library),
            "plain_ms": time_ms(plain_fn),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        row["gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
        row.update(extra)
        rows[kind].append(row)
        detail = (f"; {extra['ctas']} CTAs, workspace "
                  f"{extra['workspace_bytes']} bytes, identical bits on "
                  f"repeat" if extra else "")
        print(f"  {kind} {Dn}: chosen {cfg} {row['ms']:.4f} ms "
              f"({row['gb_s']:.0f} GB/s, {row['pct_of_bound']:.1f} % of "
              f"bound{detail}) | default {dflt} "
              f"{row['default_ms']:.4f} ms | {lib_name} "
              f"{row['library_ms']:.4f} ms | plain {row['plain_ms']:.4f} ms "
              f"| bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    del calls
    torch.cuda.empty_cache()
    for kind, ak in (("layernorm", ak_ln), ("colsum", ak_cs)):
        for row in rows[kind]:
            ratio = selection_ratio(ak.spec, timer, registry.get(ak.name),
                                    row["shape"], hw)
            row["selection_ratio"] = ratio["ratio"]
            print(f"  [18, after the main path] {ak.name} selection ratio at "
                  f"{row['shape']} (printed, not gated): chosen "
                  f"{ratio['chosen']} {ratio['chosen_time_s'] * 1e3:.4f} ms, "
                  f"best {ratio['best']} {ratio['best_time_s'] * 1e3:.4f} ms "
                  f"of {ratio['n_configs']}, ratio {ratio['ratio']:.3f}",
                  flush=True)
    phase_done(18)

    # -- 19. the entry point ---------------------------------------------------
    ln.LAUNCHES.reset()
    cs.LAUNCHES.reset()
    registry.clear()
    fresh_cache(caches)     # [18]'s drivers are in the old one
    argv = ["--arch", "llama3.2-1b", "--auto-kernels", "--requests", "3",
            "--max-new", "4", "--batch", "2", "--max-seq", "64"]
    print(f"[19] the entry point: repro_torch.launch.serve.main({argv})",
          flush=True)
    done = serve.main(argv)
    torch.cuda.synchronize()
    entry = {"layernorm": ln.LAUNCHES.count, "colsum": cs.LAUNCHES.count}
    print(f"  launches through the entry point: {entry}")
    if sorted(r.rid for r in done) != [0, 1, 2] or \
            not all(r.done and 1 <= len(r.output) <= 4 for r in done):
        raise AssertionError("the entry point did not serve every request")
    if min(entry.values()) < 1:
        raise AssertionError("the entry point did not run both kernels")
    phase_done(19)

    out = []
    for kind, ak, src, line in (
            ("layernorm", ak_ln, "layernorm.cu",
             "src/repro/kernels/layernorm.py:45"),
            ("colsum", ak_cs, "colsum.cu", "src/repro/kernels/reduce.py:47")):
        rs = rows[kind]
        total = {key: sum(r[key] for r in rs)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                             "default_ms")}
        out.append({
            "name": kind,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": line,
            "launches": launches[kind],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if all(r["bound_by"] == "operations"
                                            for r in rs) else "bytes",
            "library_ms": total["library_ms"],
            "default_ms": total["default_ms"],
            "entry_point_launches": entry[kind],
            "spec": ak.name,
            "registers": ak.capture.num_regs,
            "shapes": rs,
        })
    return tuple(out)


# A fresh process of phase 20 (a): the quickstart's build must come from the
# driver cache with no launch; prints one JSON line.
_CACHE_READER = """
import json
from repro_torch.examples import quickstart
from repro_torch.kernels.matmul import LAUNCHES
before = LAUNCHES.count
spec, oracle, hw, build = quickstart.build("cuda")
choices = {n: build.driver.choose({"m": n, "n": n, "k": n})
           for n in quickstart.SIZES}
print(json.dumps({"from_cache": build.from_cache,
                  "probes": build.collected.n_probe_executions,
                  "launches": LAUNCHES.count - before,
                  "choices": {str(n): c for n, c in choices.items()}}))
"""


def paper_phase(dev, hw, check, time_ms, phase_done, caches) -> dict:
    """Phase 20: the paper's evaluation on the card (see the module
    docstring).  Returns the f32 SIMT matmul's entry of the ``kernels``
    line."""
    import numpy as np
    import torch

    from repro_torch.benchmarks import (fig1_accuracy, fig3_system_time,
                                        table1_configs)
    from repro_torch.benchmarks.common import build_suite_drivers
    from repro_torch.configs import polybench
    from repro_torch.core.kernel_spec import POLYBENCH_LAUNCH_ALIASES
    from repro_torch.examples import quickstart
    from repro_torch.kernels.matmul import (LAUNCHES, matmul_kernel,
                                            matmul_plain)

    fig1_n, table1_ns = fig1_accuracy.N, table1_configs.SIZES
    fig3_ns = fig3_system_time.SIZES

    # -- (a) the quickstart's loop, then a fresh process reads the cache ---
    print("[20] the paper's evaluation on the card", flush=True)
    print("  (a) python -m repro_torch.examples.quickstart, into an empty "
          "driver cache", flush=True)
    cache_dir = fresh_cache(caches)
    t0 = time.perf_counter()
    first = quickstart.main([])
    first_s = time.perf_counter() - t0
    if first.from_cache or first.collected.n_probe_executions == 0:
        raise AssertionError("the quickstart's first build did not probe")
    expect = {str(n): first.driver.choose({"m": n, "n": n, "k": n})
              for n in quickstart.SIZES}
    env = dict(os.environ, PYTHONPATH=str(SRC), KLARAPTOR_CACHE_DIR=cache_dir)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CACHE_READER],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the cache reader failed:\n{proc.stderr}")
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  first process: built in {first_s:.2f} s with "
          f"{first.collected.n_probe_executions} probe executions; a fresh "
          f"process ({time.perf_counter() - t0:.2f} s, its start included): "
          f"from_cache={second['from_cache']}, probe executions "
          f"{second['probes']}, matmul launches {second['launches']}, "
          f"choices at N {list(quickstart.SIZES)} "
          f"{'identical' if second['choices'] == expect else 'DIFFER'}",
          flush=True)
    if not second["from_cache"] or second["probes"] or second["launches"] \
            or second["choices"] != expect:
        raise AssertionError(f"the fresh process did not read the driver "
                             f"from the cache: {second} against {expect}")

    # -- (b) Fig. 1 and Table I for the nine card-timed matmul rows --------
    card_rows = [n for n in polybench.suite() if n in POLYBENCH_LAUNCH_ALIASES]
    LAUNCHES.reset()                    # the f32 SIMT matmul's main path
    t0 = time.perf_counter()
    _, rows = build_suite_drivers(card_rows, device=dev)
    oracles = {row.oracle_name for row in rows.values()}
    if oracles != {"CudaEventTimer"} or len(rows) != 9:
        raise AssertionError(f"the card rows ran on {oracles}")
    if len({id(r) for r in rows.values()}) != 1:
        raise AssertionError("the nine matmul rows did not share one build")
    row = rows["gemm"]
    if row.spec.name != "matmul_b32" or LAUNCHES.count == 0 or \
            row.build.collected.n_probe_executions == 0:
        raise AssertionError("the card rows' build launched no f32 matmul")
    build_s = time.perf_counter() - t0
    spec, timer, driver = row.spec, row.oracle, row.build.driver
    passes = {}
    for n in table1_ns:
        D = polybench.eval_points(spec, sizes=(n,))[0]
        table = spec.candidates(D, hw)
        times = timer.true_time_batch(spec.traffic_table(D, table, hw))
        passes[n] = (D, table, times)
    launches = LAUNCHES.count           # the main path ends here
    print(f"  (b) the nine matmul rows on CudaEventTimer ({card_rows}), "
          f"one spec, so one driver of {spec.name}: built in "
          f"{build_s:.2f} s; one exhaustive pass per N "
          f"({', '.join(str(len(passes[n][1])) for n in table1_ns)} "
          f"configurations at N {list(table1_ns)}); f32 SIMT matmul launches "
          f"{launches} (probes, warm-ups, exhaustive passes)", flush=True)
    ratios, predicted = {}, {}
    for n in table1_ns:
        D, table, times = passes[n]
        best = int(np.argmin(times))
        chosen = driver.choose(D)
        i = next(j for j in range(len(table)) if table.row(j) == chosen)
        ratios[n] = float(times[best] / times[i])
        # the driver's E(D, P) beside the card's time, for the chosen tile
        # and the card's best: which one misleads the choice
        est = driver.estimate_batch(D, table.columns)
        predicted[n] = {"chosen_ms": float(est[i]) * 1e3,
                        "best_ms": float(est[best]) * 1e3,
                        "driver_best": table.row(int(np.argmin(est)))}
        print(f"  {'fig1' if n == fig1_n else 'table1'}/{spec.name}@N{n} "
              f"(the nine rows): card best {table.row(best)} "
              f"{times[best] * 1e3:.4f} ms (predicted "
              f"{predicted[n]['best_ms']:.4f} ms), chosen {chosen} "
              f"{times[i] * 1e3:.4f} ms (predicted "
              f"{predicted[n]['chosen_ms']:.4f} ms), ratio {ratios[n]:.3f} "
              f"(CudaEventTimer; printed, not gated); the card ranks the "
              f"chosen tile {int(np.sum(times < times[i])) + 1} of "
              f"{len(table)}, the driver ranks the card's best "
              f"{int(np.sum(est < est[best])) + 1}", flush=True)
    print(f"  fig1 card kernels at N {fig1_n}: {spec.name} ratio "
          f"{ratios[fig1_n]:.3f}, {int(ratios[fig1_n] >= 0.85)}/1 >= 0.85 "
          f"(CudaEventTimer)", flush=True)

    # the f32 SIMT matmul at Fig. 1's size with the chosen tile
    N = fig1_n
    cfg = driver.choose({"m": N, "n": N, "k": N})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(N, N, generator=gen, device=dev)
    y = torch.randn(N, N, generator=gen, device=dev) / N ** 0.5
    plain = matmul_plain(x, y)
    err = check(matmul_kernel(x, y, **cfg), plain, torch.float32,
                f"f32 SIMT matmul N {N} {cfg}")
    t_ops, t_bytes = 2.0 * N ** 3 / PEAK_F32, 3 * N * N * 4 / HBM_BW
    simt = {
        "ms": time_ms(lambda: matmul_kernel(x, y, **cfg)),
        "plain_ms": time_ms(lambda: matmul_plain(x, y), max_iters=1),
        "library_ms": time_ms(lambda: torch.matmul(x, y)),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    print(f"  f32 SIMT matmul N {N}, chosen {cfg}: {simt['ms']:.4f} ms "
          f"({2.0 * N ** 3 / simt['ms'] / 1e9:.2f} TFLOP/s, "
          f"{100 * simt['bound_ms'] / simt['ms']:.1f} % of the FP32 bound "
          f"{simt['bound_ms']:.4f} ms) | torch.matmul f32, TF32 off "
          f"{simt['library_ms']:.4f} ms | plain {simt['plain_ms']:.4f} ms",
          flush=True)
    del x, y, plain

    # -- (c) Fig. 3 for gemm, measured --------------------------------------
    (f3,) = fig3_system_time.run(kernels=("gemm",), device=dev)
    if f3["oracle"] != "CudaEventTimer":
        raise AssertionError(f"Fig. 3's gemm ran on {f3['oracle']}")
    print(f"  (c) fig3/gemm (CudaEventTimer), measured: build (anew, not "
          f"from the cache) {f3['measured_build_s']:.3f} s, exhaustive "
          f"passes over N {sorted(set(fig3_ns) - set(f3['skipped_sizes']))} "
          f"{f3['measured_exhaustive_s']:.3f} s, speedup "
          f"{f3['measured_speedup']:.1f}x; the reference's model "
          f"({fig3_system_time.RUN_OVERHEAD_S * 1e3:g} ms per run, "
          f"{fig3_system_time.MEASURE_REPS} repetitions) on the same run: "
          f"{f3['klaraptor_s']:.3f} s against {f3['exhaustive_s']:.3f} s, "
          f"{f3['speedup']:.1f}x; skipped N {f3['skipped_sizes']} (no "
          f"feasible tile: bm * bn / 64 threads stay under one warp)",
          flush=True)

    # -- (d) the other rows on HopperModel at the card's parameters --------
    others = [n for n in polybench.suite() if n not in card_rows]
    model = fig1_accuracy.run(kernels=others, device=dev)
    if {r["oracle"] for r in model} != {"HopperModel"}:
        raise AssertionError("a row without a kernel ran on the card")
    s = fig1_accuracy.summary(model)["HopperModel"]
    print(f"  (d) the other {len(others)} rows on HopperModel (the analytic "
          f"H100 at the card's parameters, not the card) at N {fig1_n}: "
          f"median ratio {s['median_ratio']:.3f}, {s['good']}/{s['rows']} "
          f">= 0.85: " + ", ".join(f"{r['kernel']} {r['ratio']:.3f}"
                                   for r in model), flush=True)
    phase_done(20)
    return {
        "name": "matmul_b32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:46",
        "launches": launches,
        "max_abs_err": err,
        **simt,
        "shape": {"m": N, "n": N, "k": N},
        "config": cfg,
        "fig1_ratio": ratios[fig1_n],
        "table1_ratios": {str(n): ratios[n] for n in table1_ns},
        "table1_predicted": {str(n): predicted[n] for n in table1_ns},
        "fig3_measured_s": {"build": f3["measured_build_s"],
                            "exhaustive": f3["measured_exhaustive_s"]},
    }


# Phase 21's envelopes: the GEMM shapes of phase 5, llama3.2-1b's attention
# (32 q heads at B 1 and 4) and mamba2-130m's SSD (24 heads at B 1) at the
# decode length 1 and prefill lengths up to phases 9 and 13's 4096.
PLAN_SEQS = [1, 512, 1024, 2048, PREFILL_S]
PLAN_ENVELOPES = {
    "matmul_b16": {"m": [4096], "n": [512, 2048, 8192, 128256],
                   "k": [2048, 8192]},
    "flash_attn_d64_causal": {"bh": [32, 128], "sq": PLAN_SEQS,
                              "skv": PLAN_SEQS},
    "ssd_scan_h64_n128": {"bh": [24], "s": PLAN_SEQS, "chunkflops": [1]},
}
PLAN_MATMULS = ("q_o_proj", "k_v_proj")

# A fresh process of phase 21 (b): warm-start from the driver cache, report
# what it loaded and the launch counters, and with "launch" make one tuned
# flash launch at llama3.2-1b's prefill shape.
_PLAN_READER = """
import json, sys
import torch
from repro_torch.core import (flash_attention_spec, local_hw, matmul_spec,
                              registry, set_choice_listener, ssd_scan_spec,
                              warm_start_from_cache)
from repro_torch.kernels import flash_attention, matmul, ops, ssd_scan
specs = [matmul_spec(2), flash_attention_spec(64, True, 2),
         ssd_scan_spec(64, 128, 2)]
summary = warm_start_from_cache(specs)
hw = local_hw()
out = {"summary": summary.as_dict(), "hw": hw.name,
       "launches": [m.LAUNCHES.count
                    for m in (matmul, flash_attention, ssd_scan)],
       "plans": {s.name: sorted(
           [sorted(a.items()), sorted(b.items())]
           for a, b in registry.plan(s.name, hw.name).entries())
           for s in specs if registry.plan(s.name, hw.name) is not None}}
if sys.argv[1] == "launch":
    events = []
    set_choice_listener(events.append)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(h, %d, 64, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (32, 8, 8))
    ops.flash_attention(q, k, v, num_q_heads=32, num_kv_heads=8)
    torch.cuda.synchronize()
    out["first"] = {"source": events[0].source, "config": events[0].config,
                    "D": events[0].D}
    out["flash_launches"] = flash_attention.LAUNCHES.count
print(json.dumps(out))
""" % PREFILL_S


def _host_us(fn, n: int) -> float:
    """Mean host microseconds of fn() over n calls."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n / 1e3


def plan_phase(dev, hw, gen, check, phase_done, caches, card: str,
               paths: dict) -> dict:
    """Phase 21: KLARAPTOR's launch plans and step plans on the card (see
    the module docstring).  ``paths`` holds phase 4's (spec, driver) and
    phases 8-9's and 12-13's drivers, models and prefill inputs.  Returns
    each kernel's launches on this path."""
    import torch

    from repro_torch.core import (DriverCache, PlanEntry, code_digest,
                                  choose_or_default, default_cache,
                                  memo_key, precompile_plans, registry,
                                  set_choice_listener, set_decision_memo)
    from repro_torch.core.step_plan import build_step_plan, use_step_plan
    from repro_torch.kernels import flash_attention, matmul, ops, ssd_scan
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import transformer as T

    print(f"[21] KLARAPTOR's launch plans on the card ({card})", flush=True)
    t_phase = time.perf_counter()
    mm_spec, mm_drv = paths["matmul"]
    specs = {mm_spec.name: (mm_spec, mm_drv)}
    for key in ("flash", "ssd"):
        specs[paths[key]["spec"].name] = (paths[key]["spec"],
                                          paths[key]["driver"])
    if set(specs) != set(PLAN_ENVELOPES):
        raise AssertionError(f"phase 21 has drivers of {sorted(specs)}")
    counters = {"matmul": matmul.LAUNCHES, "flash": flash_attention.LAUNCHES,
                "ssd": ssd_scan.LAUNCHES}
    for c in counters.values():         # this path's launches start here
        c.reset()

    # -- (a) plans into an empty cache, from the earlier phases' drivers ----
    built_in = DriverCache(caches[0])
    fresh = fresh_cache(caches)
    store = default_cache()
    registry.clear()
    for name, (spec, drv) in specs.items():
        # phase 17 wrote drivers of the same specs built on HopperModel
        entry = built_in.lookup_latest(name, hw_name=hw.name,
                                       code=code_digest(spec),
                                       source_hash=drv.source_hash)
        if entry is None:
            raise AssertionError(f"{name}: the driver phase 4/8/12 built "
                                 f"is not in the first driver cache")
        store.put(entry)
        registry.register(drv)
    t0 = time.perf_counter()
    summary = precompile_plans(PLAN_ENVELOPES, hw=hw)
    compile_s = time.perf_counter() - t0
    if sorted(summary["compiled"]) != sorted(PLAN_ENVELOPES):
        raise AssertionError(f"precompile_plans: {summary}")
    plans = {name: registry.plan(name, hw.name) for name in specs}
    for name, plan in plans.items():
        drv = specs[name][1]
        for shape, cfg in plan.entries():
            drv.namespace["_HISTORY"].clear()
            if drv.choose(shape) != cfg:
                raise AssertionError(f"{name} plan at {shape}: {cfg}, the "
                                     f"driver chooses {drv.choose(shape)}")
        if plan.source_hash != drv.source_hash or plan.code != \
                code_digest(specs[name][0]):
            raise AssertionError(f"{name}: the plan is not stamped with "
                                 f"its driver and code")
    print(f"  (a) precompile_plans into an empty cache: "
          + ", ".join(f"{n} {len(p)} entries" for n, p in plans.items())
          + f" in {compile_s * 1e3:.2f} ms wall; every entry is the "
          f"driver's choose at its shape", flush=True)
    events = []
    set_choice_listener(events.append)
    for name, m, n, k in SHAPES:
        if name not in PLAN_MATMULS:
            continue
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = (torch.randn(k, n, generator=gen, device=dev) / 32
             ).to(torch.bfloat16)
        out = ops.matmul(x, y)
        check(out, matmul.matmul_plain(x, y), torch.bfloat16,
              f"ops.matmul {name} ({m},{n},{k}) under the plan "
              f"{events[-1].config}")
        if events[-1].source != "plan":
            raise AssertionError(f"{name}: decided by {events[-1].source}")
        del x, y, out
    set_choice_listener(None)

    # -- (b) a fresh process warm-starts; a third one from edited code -----
    tampered = tempfile.mkdtemp(prefix="klaraptor-cache-")
    caches.append(tampered)
    shutil.copytree(fresh, tampered, dirs_exist_ok=True)
    bad = DriverCache(tampered)
    entry = bad.lookup_latest_plan("flash_attn_d64_causal", hw_name=hw.name)
    bad.put_plan(PlanEntry(kernel=entry.kernel, key=entry.key,
                           hw_name=entry.hw_name,
                           plan={**entry.plan, "code": "0" * 64},
                           created_at=entry.created_at,
                           tuning_version=entry.tuning_version))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PLAN_READER, arg], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), KLARAPTOR_CACHE_DIR=d))
        for arg, d in (("launch", fresh), ("warm", tampered))]
    results = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"a plan reader failed:\n{stderr}")
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    child_s = time.perf_counter() - t0
    second, third = results
    names = list(specs)
    want_plans = {n: sorted([sorted(a.items()), sorted(b.items())]
                            for a, b in p.entries())
                  for n, p in plans.items()}
    want_plans = json.loads(json.dumps(want_plans))
    D = {"bh": 32, "sq": PREFILL_S, "skv": PREFILL_S}
    first = second.get("first", {})
    print(f"  (b) a fresh process ({child_s:.2f} s for both, their starts "
          f"included; card {second['hw']}): drivers "
          f"{second['summary']['loaded']}, plans "
          f"{second['summary']['plans_loaded']}, launches during the warm "
          f"start {second['launches']}, plans "
          f"{'identical' if second['plans'] == want_plans else 'DIFFER'}; "
          f"its first tuned flash launch: source {first.get('source')} "
          f"config {first.get('config')} ({second['flash_launches']} "
          f"launch)", flush=True)
    if sorted(second["summary"]["loaded"]) != sorted(names) \
            or sorted(second["summary"]["plans_loaded"]) != sorted(names) \
            or second["launches"] != [0, 0, 0] \
            or second["plans"] != want_plans or second["hw"] != hw.name:
        raise AssertionError(f"the fresh process: {second}")
    if first.get("source") != "plan" or first.get("D") != D \
            or first.get("config") != plans[
                "flash_attn_d64_causal"].lookup(D) \
            or second["flash_launches"] != 1:
        raise AssertionError(f"the first flash launch: {first}")
    print(f"      a process from a copy whose flash plan claims other "
          f"kernel code: drivers {third['summary']['loaded']}, plans "
          f"{third['summary']['plans_loaded']}", flush=True)
    if sorted(third["summary"]["loaded"]) != sorted(names) or sorted(
            third["summary"]["plans_loaded"]) != sorted(
            n for n in names if n != "flash_attn_d64_causal"):
        raise AssertionError(f"the plan of other code was installed: "
                             f"{third}")

    # -- (c), (d) the prefills under step plans ----------------------------
    step_plans = {}
    for key, kernel in (("flash", "flash_attn_d64_causal"),
                        ("ssd", "ssd_scan_h64_n128")):
        ctx = paths[key]
        cfg, params, tokens = ctx["cfg"], ctx["params"], ctx["tokens"]
        step = make_prefill_step(ctx["model"])
        t0 = time.perf_counter()
        want = step(params, tokens)          # resolved through the registry
        torch.cuda.synchronize()
        reg_ms = (time.perf_counter() - t0) * 1e3
        sp = build_step_plan(T.decode_kernel_requests(
            cfg, batch=tokens.shape[0], max_seq=tokens.shape[1]), hw=hw)
        step_plans[key] = sp
        stats, memo = registry.stats(), registry.memo_size()
        hits = registry.memo_hits()
        set_choice_listener(events.append)
        events.clear()
        before = counters[key].count
        t0 = time.perf_counter()
        with use_step_plan(sp):
            got = step(params, tokens)
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t0) * 1e3
        set_choice_listener(None)
        n = counters[key].count - before
        same = torch.equal(got, want)
        untouched = (registry.stats() == stats
                     and registry.memo_size() == memo
                     and registry.memo_hits() == hits and not events)
        print(f"  ({'c' if key == 'flash' else 'd'}) {cfg.name} prefill "
              f"(B {tokens.shape[0]}, S {tokens.shape[1]}) under a step "
              f"plan {sp.describe()['sources']}: {n} {kernel} launches, "
              f"registry untouched: {untouched}, logits bit-identical to "
              f"the registry-resolved step: {same} (wall {sp_ms:.2f} ms; "
              f"through the registry {reg_ms:.2f} ms)", flush=True)
        if n != cfg.n_layers or not untouched or not same:
            raise AssertionError(f"{cfg.name} under a step plan: {n} "
                                 f"launches, untouched {untouched}, "
                                 f"equal {same}")
        del want, got

    # -- (e) host microseconds per decision --------------------------------
    kernel = "flash_attn_d64_causal"
    drv = specs[kernel][1]
    choose_or_default(kernel, D, ops.FLASH_DEFAULT)      # memoized
    table = plans[kernel]
    sp = step_plans["flash"]
    bare = {memo_key(kernel, hw.name, D): ops.FLASH_DEFAULT}
    bare_key = memo_key(kernel, hw.name, D)

    def driver_choose():
        drv.namespace["_HISTORY"].clear()
        drv.choose(D)

    reps = 20000
    prev = set_decision_memo(False)     # the chain behind the memo
    try:
        behind = _host_us(
            lambda: choose_or_default(kernel, D, ops.FLASH_DEFAULT), reps)
    finally:
        set_decision_memo(prev)
    us = {
        "memo hit": _host_us(
            lambda: choose_or_default(kernel, D, ops.FLASH_DEFAULT), reps),
        "plan decision, memo off": behind,
        "plan probe (registry)": _host_us(
            lambda: registry.plan_lookup(kernel, hw.name, D), reps),
        "plan probe (table)": _host_us(lambda: table.lookup(D), reps),
        "step-plan resolve": _host_us(lambda: sp.resolve(kernel, D), reps),
        "driver choose": _host_us(driver_choose, 200),
        "default": _host_us(lambda: choose_or_default(
            "untuned_kernel", D, ops.FLASH_DEFAULT), reps),
        "bare dict probe": _host_us(lambda: bare.get(bare_key), reps),
    }
    if sp.stale():
        raise AssertionError("the llama step plan went stale")
    print(f"  (e) host us per decision for {kernel} at {D} (printed, not "
          f"gated): " + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
          + f"; the tuned flash launch takes {paths['flash']['launch_ms']:.4f}"
          f" ms on the card (phase 9)", flush=True)

    launches = {k: c.count for k, c in counters.items()}   # path ends here
    print(f"  launches on this path: {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the plan path never launched: "
                             f"{launches}")
    registry.clear()
    phase_done(21)
    print(json.dumps({"plans": {"entries": {n: len(p)
                                            for n, p in plans.items()},
                                "compile_ms": compile_s * 1e3,
                                "host_us": us, "card": card}}))
    return launches


# Phase 22: qwen3-moe-235b-a22b at the full width of its config, cut to 4 of
# its 94 layers (about 22.4 GB of bf16 weights: 4.83 GB of experts per layer,
# 2.49 GB of embedding and head), the prefill at B 1 x S 4096 and the engine
# of phase 10; and the groups its device profile sums kernel time by (first
# match wins; the grouped matmul is the only gemm_sm90 launch on this path).
QWEN_ARCH = "qwen3-moe-235b-a22b"
QWEN_LAYERS = 4
MOE_PROFILE_GROUPS = (
    ("grouped matmul", ("gemm_sm90::",)),
    ("flash", ("flash_",)),
    ("cuBLAS", GEMM_NAMES),
    ("sort and top-k", ("sort", "radix", "topk", "search", "scan")),
    ("gather and scatter", ("index", "scatter", "gather")),
)


def _routing_agreement(a, b) -> tuple[float, float]:
    """Share of the (token, slot) choices of routing ``a`` (..., k) that
    are among the same token's choices in ``b``, and the share equal slot
    for slot."""
    in_b = (a[..., :, None] == b[..., None, :]).any(-1)
    return float(in_b.float().mean()), float((a == b).float().mean())


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def moe_phase(dev, hw, gen, check, time_ms, phase_done, caches, card: str,
              gmm_ctx: dict) -> dict:
    """Phase 22: qwen3-moe-235b-a22b's serving path on the card (see the
    module docstring).  ``gmm_ctx`` holds phase 16's grouped-matmul spec,
    driver and timer.  Returns this path's launches and its flash and
    grouped-matmul rows at the layer's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import (DriverCache, Klaraptor, code_digest,
                                  default_cache, flash_attention_spec,
                                  flash_probe_data, get_driver, registry,
                                  selection_ratio)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops
    from repro_torch.launch import build_engine, make_prefill_step
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.serving import Request, greedy

    cfg = get_config(QWEN_ARCH).replace(n_layers=QWEN_LAYERS)
    print(f"[22] {QWEN_ARCH} at full width ({card}): d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, qk-norm, "
          f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.moe_d_ff}, "
          f"capacity factor {cfg.capacity_factor}, groups of "
          f"{cfg.moe_group} tokens, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{QWEN_LAYERS} of the config's 94 layers, seeded random weights",
          flush=True)
    t_phase = time.perf_counter()

    # the drivers: phase 16's, read back through the driver cache given its
    # spec (phase 21 cleared the registry), and one for head dim 128 built
    # as phase 8 builds head dim 64's
    gspec, gdrv, timer = gmm_ctx["spec"], gmm_ctx["driver"], gmm_ctx["timer"]
    entry = DriverCache(caches[0]).lookup_latest(
        gspec.name, hw_name=hw.name, code=code_digest(gspec),
        source_hash=gdrv.source_hash)
    if entry is None:
        raise AssertionError("phase 16's driver is not in the first cache")
    fresh_cache(caches)
    default_cache().put(entry)
    registry.clear()
    read = get_driver(gspec.name, gspec, hw)
    if read is None or read.source_hash != gdrv.source_hash \
            or registry.get(gspec.name) is not read:
        raise AssertionError("phase 16's driver did not read back")
    gdrv = read
    fspec = flash_attention_spec(cfg.head_dim, causal=True, dtype_bytes=2)
    fbuild = Klaraptor(timer).build_driver(
        fspec, probe_data=flash_probe_data(), repeats=2,
        max_configs_per_size=12)
    fdrv = fbuild.driver
    cols = fbuild.collected.columns
    if int(cols["bh"].max()) > 64 or int(cols["sq"].max()) > 1024:
        raise AssertionError("flash d 128 probes left bh <= 64, sq <= 1024")
    print(f"  drivers: {gspec.name} read back through the driver cache "
          f"(phase 16's build); {fspec.name} built on the card "
          f"({fbuild.collected.n_probe_executions} probe executions at "
          f"bh <= 64, sq = skv <= 1024)", flush=True)

    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    # what a decode step reads: every weight but the embedding table, of
    # which it gathers one row per sequence
    weight_bytes = sum(t.numel() * t.element_size() for name, t in
                       params.items() if name != "embed" and not
                       isinstance(t, dict)) + sum(
        t.numel() * t.element_size() for t in _leaves(params["blocks"]))
    expert_bytes = sum(params["blocks"]["pos0"][k].numel() * 2
                       for k in ("we_gate", "we_up", "we_down"))
    print(f"  init {time.perf_counter() - t0:.2f} s: "
          f"{weight_bytes / 1e9:.2f} GB of weights besides the embedding, "
          f"experts "
          f"{expert_bytes / QWEN_LAYERS / 1e9:.2f} GB per layer", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), generator=gen,
                           device=dev)
    step = make_prefill_step(model)
    routes: dict[str, list] = {"tuned": [], "plain": []}
    real_route = L.moe_route
    run_name = ["tuned"]

    def recording_route(c, p, xg):
        out = real_route(c, p, xg)
        routes[run_name[0]].append(out[2])
        return out

    recorded = {"attn": None, "gmm": []}

    def plain_attn(q, k, v, **kw):
        if recorded["attn"] is None:
            recorded["attn"] = (q, k, v, kw)
        return flash.flash_attention_plain(q, k, v, **kw)

    def plain_gmm(x, w):
        if len(recorded["gmm"]) < 3:
            recorded["gmm"].append((x, w))
        return gmm.moe_gmm_plain(x, w)

    counters = {"flash": flash.LAUNCHES, "moe_gmm": gmm.LAUNCHES}
    for c in counters.values():          # the phase-22 path starts here
        c.reset()

    # -- (a) the prefill step, and (b)'s plain step ------------------------
    L.moe_route = recording_route
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, tokens)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        per_step = {k: c.count for k, c in counters.items()}
        run_name[0] = "plain"
        t0 = time.perf_counter()
        ref_logits = make_prefill_step(model, attn_op=plain_attn,
                                       gmm_op=plain_gmm)(params, tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        L.moe_route = real_route
    print(f"  (a) prefill B 1 x S {PREFILL_S}: first call {first_ms:.2f} ms "
          f"wall; launches in the step {per_step} (want flash "
          f"{cfg.n_layers}, moe_gmm {3 * cfg.n_layers})", flush=True)
    if per_step != {"flash": cfg.n_layers, "moe_gmm": 3 * cfg.n_layers}:
        raise AssertionError(f"the prefill launched {per_step}")
    V = cfg.vocab_size
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits[:, :V]).all()):
        raise AssertionError(f"prefill logits {logits.shape} not finite")
    t0 = time.perf_counter()
    step(params, tokens)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"      second call {warm_ms:.2f} ms wall", flush=True)
    profile = _device_profile(lambda: step(params, tokens),
                              "one qwen3-moe prefill step",
                              groups=MOE_PROFILE_GROUPS)

    # -- (b) the logits against the plain step, and the routing -----------
    scale = float(ref_logits[:, :V].abs().max())
    diff = float((logits[:, :V] - ref_logits[:, :V]).abs().max())
    agree = int(greedy(logits)[0]) == int(greedy(ref_logits)[0])
    print(f"  (b) logits vs the step with plain flash and the plain grouped "
          f"matmul ({plain_s:.2f} s wall): max|diff| {diff:.4e}, max|logit| "
          f"{scale:.4e}, ratio {diff / scale:.3e} (tol {LOGIT_REL_TOL:g}); "
          f"argmax agrees: {agree}", flush=True)
    agreement = []
    for li, (a, b) in enumerate(zip(routes["tuned"], routes["plain"])):
        as_set, in_order = _routing_agreement(a, b)
        agreement.append({"layer": li, "set": as_set, "slot": in_order})
        print(f"      layer {li}: {as_set:.6f} of the (token, slot) choices "
              f"are among the plain step's ({in_order:.6f} slot for slot)")
    if len(agreement) != cfg.n_layers:
        raise AssertionError(f"routed {len(agreement)} layers")
    if not diff <= LOGIT_REL_TOL * scale:
        raise AssertionError("qwen3-moe logits disagree with the plain step")
    del ref_logits, routes
    torch.cuda.empty_cache()

    # -- (d) the serving engine --------------------------------------------
    engine = build_engine(cfg, batch=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          params=params, seed=SEED)
    rng = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rng.randint(2, V, size=8 + 32 * i // 7)]
               for i in range(N_REQUESTS)]
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                              temperature=0.0 if i % 2 == 0 else 0.8))
    before = gmm.LAUNCHES.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the eager first step's launches count in LAUNCHES, the decode
    # graph's as its replays times its launches per replay
    graphed = engine.graph_launches()
    engine_gmm = gmm.LAUNCHES.count - before + graphed.get("moe_gmm", 0)
    calls = engine.steps + sum(len(p) - 1 for p in prompts)
    decode_ms = wall / calls * 1e3
    decode_bound_ms = weight_bytes / HBM_BW * 1e3
    print(f"  (d) serving engine: {ENGINE_SLOTS} slots, max_seq "
          f"{ENGINE_MAX_SEQ}, {N_REQUESTS} requests of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens, "
          f"{MAX_NEW} new tokens each, half greedy: {len(done)} finished; "
          f"{calls} decode-step calls in {wall:.2f} s: {decode_ms:.2f} ms "
          f"per call against a weight-read bound of {decode_bound_ms:.2f} ms "
          f"({weight_bytes / 1e9:.2f} GB at {HBM_BW / 1e12:.2f} TB/s; at "
          f"most {ENGINE_SLOTS * cfg.top_k} of {cfg.n_experts} experts hold "
          f"a token in a step, and the kernel reads every expert); "
          f"grouped-matmul launches {engine_gmm} ({3 * cfg.n_layers} per "
          f"call; {graphed.get('moe_gmm', 0)} of them by graph replays)",
          flush=True)
    _print_captures(engine)
    if sorted(r.rid for r in done) != list(range(N_REQUESTS)) \
            or not all(r.done and 1 <= len(r.output) <= MAX_NEW
                       for r in done):
        raise AssertionError("not every request finished")
    if engine.compile_counts["decode_step"] != 1:
        raise AssertionError(f"compile_counts {engine.compile_counts}")
    if engine_gmm != 3 * cfg.n_layers * calls:
        raise AssertionError(f"{engine_gmm} grouped-matmul launches in "
                             f"{calls} decode steps")
    tok = torch.tensor(engine.slot_last, device=dev)
    pos = torch.tensor(np.arange(ENGINE_SLOTS) + 64, device=dev,
                       dtype=torch.int32)

    def decode_steps():
        for _ in range(4):
            engine.model.decode_step(params, tok, pos, engine.cache)

    decode_profile = _device_profile(
        decode_steps, f"4 eager decode steps at batch {ENGINE_SLOTS}",
        groups=MOE_PROFILE_GROUPS)
    launches = {k: c.count for k, c in counters.items()}  # the path ends
    launches["moe_gmm"] += graphed.get("moe_gmm", 0)
    print(f"  launches on this path: {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the qwen3-moe path never "
                             f"launched: {launches}")
    del engine
    torch.cuda.empty_cache()

    # -- (c) the tuned launches at the layer's shapes ----------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  (c) layer 0's launches at their shapes ({card}, {sms} SMs): "
          f"the tuned tile, the default, one PyTorch call, the plain "
          f"version, the bound; selection ratios against exhaustive timing "
          f"of the compiled tiles printed, not gated", flush=True)
    (xe, we_gate), _, (hh, we_down) = recorded["gmm"]
    cases = (("prefill gate/up", xe, we_gate), ("prefill down", hh, we_down),
             ("decode gate/up", xe[:, :8].contiguous(), we_gate),
             ("decode down", hh[:, :8].contiguous(), we_down))
    def check_at_scale(out, plain, library, exact, what: str) -> float:
        """The kernel against the plain version on the layer's own
        activations, which reach 1e5 in the down product (this model's
        mirrored init fault): the bf16 tolerance at the output's scale,
        |out - plain| <= 2e-2 (max |plain| + |plain|), the form the model
        tests use.  Sums of such terms that cancel to near zero differ by
        their f32 summation order alone, beyond the kernel tests' fixed
        2e-2; the count of those elements is printed for the kernel and
        for ``torch.bmm``, held to the same plain version, and the largest
        error of each of the three against the f64 product ``exact``."""
        scale = float(plain.float().abs().max())
        diff = (out.float() - plain.float()).abs()
        err = float(diff.max())
        fixed = 2e-2 + 2e-2 * plain.float().abs()
        beyond = int((diff > fixed).sum())
        lib = int(((library.float() - plain.float()).abs() > fixed).sum())
        ok = bool(torch.isfinite(out).all()) and bool(
            (diff <= 2e-2 * (scale + plain.float().abs())).all())
        vs_exact = [float((t.double() - exact).abs().max())
                    for t in (out, library, plain)]
        print(f"    {what} vs plain: max_abs_err {err:.3e} at max|plain| "
              f"{scale:.4e} (tol 2e-2 of it) {'ok' if ok else 'FAIL'}; "
              f"elements beyond the fixed 2e-2: kernel {beyond}, torch.bmm "
              f"{lib}; largest error against the f64 product: kernel "
              f"{vs_exact[0]:.4g}, torch.bmm {vs_exact[1]:.4g}, plain "
              f"{vs_exact[2]:.4g}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: kernel disagrees with plain")
        return err

    gmm_rows = []
    worst = 0.0
    for name, x, w in cases:
        e, g, k = x.shape
        n = w.shape[2]
        D = ops.gemm_dims(gspec.name, {"e": e, "g": g, "k": k, "n": n})
        cfg_t = gdrv.choose(D)
        dflt = ops._fit_gemm(gspec.name, ops.GMM_DEFAULT,
                             {"bg": D["g"], "bn": D["n"], "bk": D["k"]})
        xp = F.pad(x, (0, 0, 0, D["g"] - g))
        err = check_at_scale(ops.moe_gmm(x, w), gmm.moe_gmm_plain(x, w),
                             torch.bmm(x, w),
                             torch.bmm(x.double(), w.double()), name)
        worst = max(worst, err)
        flops = 2.0 * e * g * k * n
        t_ops = flops / PEAK_BF16
        t_bytes = (e * g * k + e * k * n + e * g * n) * 2 / HBM_BW
        ratio = selection_ratio(gspec, timer, gdrv, D, hw)
        r = {
            "shape": name, "e": e, "g": g, "k": k, "n": n,
            "padded_g": D["g"], "config": cfg_t, "default": dflt,
            "max_abs_err": err,
            "ms": time_ms(lambda: gmm.moe_gmm_kernel(xp, w, **cfg_t)),
            "op_ms": time_ms(lambda: ops.moe_gmm(x, w)),
            "default_ms": time_ms(lambda: gmm.moe_gmm_kernel(xp, w, **dflt)),
            "library_ms": time_ms(lambda: torch.bmm(x, w)),
            "plain_ms": time_ms(lambda: gmm.moe_gmm_plain(x, w),
                                max_iters=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ctas": e * (D["g"] // cfg_t["bg"]) * (n // cfg_t["bn"]),
            "selection_ratio": ratio["ratio"], "best": ratio["best"],
            "n_configs": ratio["n_configs"],
        }
        r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
        gmm_rows.append(r)
        rows_note = f"g {g}" if D["g"] == g else f"g {g} padded to {D['g']}"
        print(f"    {name} (e {e}, {rows_note}, k {k}, n {n}): chosen "
              f"{cfg_t} {r['ms']:.4f} ms ({r['pct_of_bound']:.1f} % of "
              f"bound, {r['ctas']} CTAs, {r['ctas'] / sms:.1f} per SM) | "
              f"ops.moe_gmm {r['op_ms']:.4f} ms | default {dflt} "
              f"{r['default_ms']:.4f} ms | torch.bmm {r['library_ms']:.4f} "
              f"ms | plain {r['plain_ms']:.2f} ms | bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | selection ratio "
              f"{ratio['ratio']:.3f} (best {ratio['best']} of "
              f"{ratio['n_configs']})", flush=True)
        del xp
    q, k, v, kw = recorded["attn"]
    heads = dict(num_q_heads=kw["num_q_heads"],
                 num_kv_heads=kw["num_kv_heads"])
    D = {"bh": q.shape[0], "sq": PREFILL_S, "skv": PREFILL_S}
    fcfg = fdrv.choose(D)
    ferr = check(
        flash.flash_attention_kernel(q, k, v, causal=True, **fcfg, **heads),
        flash.flash_attention_plain(q, k, v, causal=True,
                                    q_chunk=cfg.attn_chunk, **heads),
        torch.bfloat16, "layer 0 flash vs plain", quiet=True)
    q4 = q.view(1, heads["num_q_heads"], PREFILL_S, cfg.head_dim)
    k4 = k.view(1, heads["num_kv_heads"], PREFILL_S, cfg.head_dim)
    v4 = v.view(1, heads["num_kv_heads"], PREFILL_S, cfg.head_dim)
    bound, bound_by = _flash_bound_ms(q.shape[0], PREFILL_S, PREFILL_S,
                                      k.shape[0], cfg.head_dim, True, 2)
    fratio = selection_ratio(fspec, timer, fdrv, D, hw)
    frow = {
        "shape": f"bh {D['bh']} (GQA {heads['num_q_heads']}/"
                 f"{heads['num_kv_heads']}), S {PREFILL_S}, d {cfg.head_dim}",
        "config": fcfg, "max_abs_err": ferr,
        "ms": time_ms(lambda: flash.flash_attention_kernel(
            q, k, v, causal=True, **fcfg, **heads)),
        "default_ms": time_ms(lambda: flash.flash_attention_kernel(
            q, k, v, causal=True, **ops.FLASH_DEFAULT, **heads)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)),
        "plain_ms": time_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=True, q_chunk=cfg.attn_chunk, **heads),
            max_iters=1),
        "bound_ms": bound, "bound_by": bound_by,
        "selection_ratio": fratio["ratio"],
    }
    frow["pct_of_bound"] = 100.0 * bound / frow["ms"]
    print(f"    flash {frow['shape']}: chosen {fcfg} {frow['ms']:.4f} ms "
          f"({frow['pct_of_bound']:.1f} % of bound) | default "
          f"{frow['default_ms']:.4f} ms | SDPA {frow['library_ms']:.4f} ms | "
          f"plain {frow['plain_ms']:.2f} ms | bound {bound:.4f} ms "
          f"({bound_by}) | max_abs_err {ferr:.3e} | selection ratio "
          f"{fratio['ratio']:.3f} (best {fratio['best']} of "
          f"{fratio['n_configs']})", flush=True)
    xr = torch.randn(PREFILL_S, cfg.d_model, generator=gen, device=dev)
    router = params["blocks"]["pos0"]["router"][0]
    router_ms = time_ms(lambda: xr @ router)
    print(f"    router product (f32, {PREFILL_S} x {cfg.d_model} @ "
          f"{cfg.d_model} x {cfg.n_experts}): {router_ms:.4f} ms", flush=True)
    del recorded, step, q, k, v, q4, k4, v4, xr, router
    torch.cuda.empty_cache()
    registry.clear()
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(22)
    print(json.dumps({"qwen3_moe": {
        "prefill_first_ms": first_ms, "prefill_warm_ms": warm_ms,
        "launches_per_prefill": per_step, "logit_ratio": diff / scale,
        "routing_agreement": agreement, "prefill_profile": profile,
        "decode_ms_per_call": decode_ms,
        "decode_weight_bound_ms": decode_bound_ms,
        "decode_profile": decode_profile, "router_ms": router_ms,
        "flash": frow, "moe_gmm": gmm_rows, "card": card}}))
    return {"launches": launches, "flash": frow, "moe_gmm": gmm_rows,
            "max_abs_err": worst, "cfg": cfg, "model": model,
            "params": params, "weight_bytes": weight_bytes,
            "decode_ms_per_call": decode_ms, "drivers": [gdrv, fdrv]}


# Phase 23: the engines' decode timing, and bench_serving's engine stage
# (batch 4, max_seq 96, 32 prompt lengths 17-79, 2 new tokens, chunk 32).
DECODE_CALLS = 20
ASYNC_LENS = tuple(17 + 2 * i for i in range(32))
ASYNC_BATCH, ASYNC_MAX_SEQ, ASYNC_MAX_NEW, ASYNC_CHUNK = 4, 96, 2, 32
ASYNC_RATIO_BAR = 1.5     # benchmarks/BENCH_serving.json's, on the TPU path


def engine_phase(dev, hw, gen, check, phase_done, caches, card: str,
                 mm_ctx: tuple, qwen: dict) -> dict:
    """Phase 23: the serving engine's CUDA graphs, the in-graph ops with
    bucketed dispatch, the async front-end with chunked prefill, and plans
    in the engine (see the module docstring).  ``mm_ctx`` is phase 4's
    (spec, driver); ``qwen`` phase 22's config, model, parameters and
    weight bytes.  Returns this path's launches per kernel (the counters
    set to 0 at its start, plus the graph replays' launches)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (BucketLattice, DriverCache,
                                  build_bucketed_dispatch, code_digest,
                                  default_cache, get_driver, registry)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce as cs
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.launch import (build_engine, default_bucket_lattices,
                                    default_plan_envelope)
    from repro_torch.models import Model
    from repro_torch.serving import Request, greedy
    from repro_torch.serving.graphs import LAUNCH_COUNTERS, BranchGraphs

    print(f"[23] the serving engine on the card ({card}): decode as a CUDA "
          f"graph against the eager step, in-graph ops with bucketed "
          f"dispatch, the async front-end with chunked prefill, plans in "
          f"the engine", flush=True)
    t_phase = time.perf_counter()
    graphed: dict[str, int] = {}
    errs: dict[str, float] = {}

    def note(launched: dict) -> None:
        for k, n in launched.items():
            graphed[k] = graphed.get(k, 0) + n

    for c in LAUNCH_COUNTERS.values():     # the phase-23 path starts here
        c.reset()

    # -- (a) decode: eager against graphed ---------------------------------
    print(f"  (a) decode at batch {ENGINE_SLOTS}, max_seq {ENGINE_MAX_SEQ}: "
          f"{DECODE_CALLS} calls each of the engine's graphed step and of "
          f"the eager model.decode_step on the same inputs (a call: the "
          f"step, then its greedy tokens read to the host); logits gate "
          f"{LOGIT_REL_TOL:g} x max|logit|", flush=True)
    decode_rows = {}
    llama = None
    for arch, cfg, model, params in (
            ("llama3.2-1b", get_config("llama3.2-1b"), None, None),
            ("mamba2-130m", get_config("mamba2-130m"), None, None),
            (f"{QWEN_ARCH} ({QWEN_LAYERS} layers)", qwen["cfg"],
             qwen["model"], qwen["params"])):
        laps, t_lap = {}, [time.perf_counter()]

        def lap(name):
            t = time.perf_counter()
            laps[name] = t - t_lap[0]
            t_lap[0] = t

        if model is None:
            model = Model(cfg)
            params = model.init(SEED)
        if arch == "llama3.2-1b":
            llama = (cfg, params)
        V = cfg.vocab_size
        lap("init")
        engine = build_engine(cfg, batch=ENGINE_SLOTS,
                              max_seq=ENGINE_MAX_SEQ, params=params,
                              seed=SEED)
        lap("engine")
        rng = np.random.RandomState(SEED)
        for i in range(ENGINE_SLOTS):
            engine.submit(Request(rid=i, prompt=[
                int(t) for t in rng.randint(2, V, size=6 + 2 * i)],
                max_new_tokens=8))
        done = engine.run()
        if len(done) != ENGINE_SLOTS or not all(r.done for r in done):
            raise AssertionError(f"{arch}: not every request finished")
        lap("traffic")
        tok = np.arange(ENGINE_SLOTS, dtype=np.int32) + 5
        pos = np.arange(ENGINE_SLOTS, dtype=np.int32) + 64
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in engine.cache.items()}

        def eager_step():
            logits, _ = model.decode_step(
                params, torch.as_tensor(tok, device=dev),
                torch.as_tensor(pos, device=dev), engine.cache)
            return logits

        def restore():
            for k, v in saved.items():
                for n, t in v.items():
                    engine.cache[k][n].copy_(t)

        torch.cuda.synchronize()
        want = eager_step()[:, :V].clone()
        restore()
        got = engine._run_step(tok, pos)[:, :V].clone()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        restore()

        def timed(call) -> float:
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DECODE_CALLS):
                call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / DECODE_CALLS * 1e3

        def eager_call():
            return greedy(eager_step()).cpu()

        def graphed_call():
            return greedy(engine._run_step(tok, pos)).cpu()

        row = {"graphed_ms": timed(graphed_call),
               "eager_ms": timed(eager_call),
               "max_logit_diff": diff, "max_logit": scale,
               "bit_equal": diff == 0.0}
        lap("timing")
        for mode, call in (("graphed", graphed_call), ("eager", eager_call)):
            prof = _device_profile(
                lambda: [call() for _ in range(DECODE_CALLS)],
                f"{arch}, {DECODE_CALLS} {mode} decode calls",
                groups=MOE_PROFILE_GROUPS, cpu=False)
            row[f"{mode}_busy"] = (prof["busy_ms"] / prof["wall_ms"]
                                   if prof else None)
            row[f"{mode}_device_ms"] = (prof["busy_ms"] / DECODE_CALLS
                                        if prof else None)
        restore()
        lap("profiles")
        cc = dict(engine.compile_counts)
        row["compile_counts"] = cc
        row["captures"] = [{"capture_s": st.capture_s,
                            "pool_bytes": st.pool_bytes,
                            "launches": st.launches} for st in
                           engine.captures()]
        bound = ""
        if qwen["model"] is model:
            row["weight_bound_ms"] = qwen["weight_bytes"] / HBM_BW * 1e3
            bound = (f"; weight-read bound {row['weight_bound_ms']:.2f} ms "
                     f"({qwen['weight_bytes'] / 1e9:.2f} GB at "
                     f"{HBM_BW / 1e12:.2f} TB/s)")

        def share(mode):
            """The profile's busy share, and the profile's device ms per
            call over the unprofiled ms per call (the profiler slows the
            host, not the device)."""
            if row[f"{mode}_busy"] is None:
                return "device time not measured"
            dev_ms = row[f"{mode}_device_ms"]
            return (f"device {dev_ms:.3f} ms per call, "
                    f"{dev_ms / row[f'{mode}_ms']:.1%} of the call; busy "
                    f"{row[f'{mode}_busy']:.1%} under the profiler")

        print(f"    {arch}: graphed {row['graphed_ms']:.3f} ms per call "
              f"({share('graphed')}), eager {row['eager_ms']:.3f} ms "
              f"({share('eager')}), "
              f"{row['eager_ms'] / row['graphed_ms']:.2f}x{bound}; "
              f"logits max|graphed - eager| {diff:.4e} of max|logit| "
              f"{scale:.4e} (bit-equal: {diff == 0.0}); {cc}", flush=True)
        _print_captures(engine)
        if cc["decode_step"] != 1:
            raise AssertionError(f"{arch}: {cc['decode_step']} decode "
                                 f"captures, not 1")
        if not diff <= LOGIT_REL_TOL * scale:
            raise AssertionError(f"{arch}: graphed logits disagree with "
                                 f"the eager step")
        note(engine.graph_launches())
        decode_rows[arch] = row
        del engine, saved
        if model is not qwen["model"] and arch != "llama3.2-1b":
            del model, params
        gc.collect()          # an engine and its graphs form a cycle
        torch.cuda.empty_cache()
        lap("teardown")
        row["wall_s"] = laps
        print(f"    {arch}: wall " + ", ".join(f"{k} {v:.2f} s"
                                               for k, v in laps.items()),
              flush=True)

    print(f"  (a) wall {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- (b) bucketed dispatch: one graph per branch -----------------------
    t_part = time.perf_counter()
    registry.clear()

    def read_back(spec, source_hash=None):
        """The newest driver of ``spec`` in the run's first cache, put in
        the current cache and read through it (None if there is none)."""
        entry = DriverCache(caches[0]).lookup_latest(
            spec.name, hw_name=hw.name, code=code_digest(spec),
            source_hash=source_hash)
        if entry is None:
            return None
        default_cache().put(entry)
        return get_driver(spec.name, spec, hw)

    def bucketed(label, disp, drv, call, cases):
        """``cases``: (raw D, fill the padded buffers, the plain output,
        cut the envelope-shaped output to the raw shape)."""
        lat = disp.lattice
        graphs = BranchGraphs(disp, call, dev)
        worst, hits, waste, agree = 0.0, 0, 0.0, 0
        for D, fill, plain, cut in cases:
            fill()
            out = cut(graphs(D))
            worst = max(worst, check(out, plain, torch.bfloat16,
                                     f"{label} {D}", quiet=True))
            idx, hit = disp.branch_index(D)
            h_idx, h_hit = disp.host_index(D)
            if (int(idx), bool(hit)) != (h_idx, h_hit):
                raise AssertionError(f"{label} {D}: device branch "
                                     f"{int(idx), bool(hit)}, host "
                                     f"{h_idx, h_hit}")
            agree += 1
            hits += int(h_hit)
            waste += lat.padding_waste(D)
        torch.cuda.synchronize()
        if graphs.captures > disp.n_branches:
            raise AssertionError(f"{label}: {graphs.captures} captures for "
                                 f"{disp.n_branches} branches")
        checked = 0
        if drv is not None:
            for bucket in lat.all_buckets():
                cfg, hit = disp.host_config(bucket)
                try:
                    ref = drv.choose(bucket)
                except ValueError:
                    if hit:
                        raise AssertionError(f"{label}: infeasible bucket "
                                             f"{bucket} hit the plan")
                    continue
                if not hit or cfg != {p: int(v) for p, v in ref.items()}:
                    raise AssertionError(f"{label}: bucket {bucket} takes "
                                         f"{cfg}, the driver chooses {ref}")
                checked += 1
        note(graphs.launched())
        r = {"kernel": disp.table.kernel, "shapes": len(cases),
             "hits": hits, "misses": len(cases) - hits,
             "buckets": lat.n_buckets, "branches": disp.n_branches,
             "captures": graphs.captures, "host_device_agree": agree,
             "buckets_equal_choose": checked, "driver": drv is not None,
             "mean_padding_waste": waste / len(cases), "max_abs_err": worst,
             "capture_s": [st.capture_s for st in graphs.steps.values()]}
        print(f"    {label}: {len(cases)} raw shapes, {hits} hits, "
              f"{len(cases) - hits} misses, mean padding waste "
              f"{r['mean_padding_waste']:.3f}; {lat.n_buckets} buckets, "
              f"{disp.n_branches} branches, {graphs.captures} captures; "
              f"host_index = branch_index on {agree}; "
              + (f"every bucket's config = the driver's choose "
                 f"({checked} feasible buckets)" if drv is not None
                 else "no driver read back: every shape on the default "
                 "branch")
              + f"; max_abs_err {worst:.3e} (2e-2, the bf16 kernel tests')",
              flush=True)
        return r

    print("  (b) bucketed dispatch: raw shapes padded into the lattice "
          "envelope, one CUDA graph captured per branch taken; plans built "
          "from the drivers of phases 4, 8 and 18 read back through the "
          "driver cache", flush=True)
    buckets = {}
    spec, mm_drv = mm_ctx
    drv = read_back(spec, mm_drv.source_hash)
    if drv is None or drv.source_hash != mm_drv.source_hash:
        raise AssertionError("phase 4's matmul_b16 driver did not read back")
    lat = BucketLattice.from_spec(spec, {"m": (64, 512), "n": (256, 1024),
                                         "k": (256, 1024)}, hw=drv.hw)
    mm_disp = build_bucketed_dispatch(spec.name, lat, ops.MATMUL_DEFAULT,
                                      device=dev)
    env = lat.envelope_shape()
    xp = torch.zeros(env["m"], env["k"], dtype=torch.bfloat16, device=dev)
    yp = torch.zeros(env["k"], env["n"], dtype=torch.bfloat16, device=dev)
    cases = []
    for i in range(34):
        m, n, k = 40 + 13 * i, 200 + (23 * i) % 800, 100 + (29 * i) % 900
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
             ).to(torch.bfloat16)

        def fill(x=x, y=y, m=m, n=n, k=k):
            xp.zero_()[:m, :k] = x
            yp.zero_()[:k, :n] = y

        cases.append(({"m": m, "n": n, "k": k}, fill, matmul_plain(x, y),
                      lambda out, m=m, n=n: out[:m, :n]))
    buckets["matmul"] = bucketed(
        "matmul_b16", mm_disp, drv,
        lambda D: ops.matmul(xp, yp, in_graph=mm_disp, dims=D), cases)
    del xp, yp, cases

    BH, S, d = 8, 256, 64
    fspec = ops.kernel_spec(ops.flash_kernel_name(d, True))
    fdrv = read_back(fspec)
    flat = BucketLattice.from_axes(fspec.name, {
        "bh": [BH], "sq": [64, 128, 256], "skv": [64, 128, 256]})
    f_disp = build_bucketed_dispatch(fspec.name, flat, ops.FLASH_DEFAULT,
                                     device=dev)
    qkv = [torch.zeros(BH, S, d, dtype=torch.bfloat16, device=dev)
           for _ in range(3)]
    cases = []
    for s in (40, 100, 200, 256):
        raw = [torch.randn(BH, s, d, generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3)]

        def fill(raw=raw, s=s):
            for buf, t in zip(qkv, raw):
                buf.zero_()[:, :s] = t

        cases.append(({"bh": BH, "sq": s, "skv": s}, fill,
                      flash.flash_attention_plain(
                          *raw, num_q_heads=BH, num_kv_heads=BH,
                          causal=True),
                      lambda out, s=s: out[:, :s]))
    buckets["flash"] = bucketed(
        f"{fspec.name} (bh {BH}, d {d})", f_disp, fdrv,
        lambda D: ops.flash_attention(*qkv, num_q_heads=BH, num_kv_heads=BH,
                                      causal=True, in_graph=f_disp, dims=D),
        cases)
    del qkv, cases

    c_ln, R = AUTO_D_MODEL, 4096
    ak = ops._layernorm_auto(c_ln, 2, 1e-6, "cuda")
    ldrv = read_back(ak.spec)
    llat = BucketLattice.from_axes(ak.name, {"r": [1024, 2048, 4096]})
    l_disp = build_bucketed_dispatch(ak.name, llat, ak.defaults, device=dev)
    xl = torch.zeros(R, c_ln, dtype=torch.bfloat16, device=dev)
    rl = torch.zeros(R, c_ln, dtype=torch.bfloat16, device=dev)
    g = torch.randn(c_ln, generator=gen, device=dev)
    b = torch.randn(c_ln, generator=gen, device=dev)
    cases = []
    for r in (1000, 2048, 3000, 4096):
        xr, rr = (torch.randn(r, c_ln, generator=gen, device=dev
                              ).to(torch.bfloat16) for _ in range(2))

        def fill(xr=xr, rr=rr, r=r):
            xl.zero_()[:r] = xr
            rl.zero_()[:r] = rr

        cases.append(({"r": r}, fill, ln.layernorm_plain(xr, rr, g, b, 1e-6),
                      lambda out, r=r: out[:r]))
    buckets["layernorm"] = bucketed(
        ak.name, l_disp, ldrv,
        lambda D: ops.layernorm(xl, rl, g, b, in_graph=l_disp, dims=D),
        cases)
    del xl, rl, cases

    ak = ops._colsum_auto(2, "cuda")
    cdrv = read_back(ak.spec)
    clat = BucketLattice.from_axes(ak.name, {"r": [2048, 4096, 8192],
                                             "c": [1024, 2048, 4096]})
    c_disp = build_bucketed_dispatch(ak.name, clat, ak.defaults, device=dev)
    xc = torch.zeros(8192, 4096, dtype=torch.bfloat16, device=dev)
    cases = []
    for r, cc in ((3000, 1000), (8192, 4096), (5000, 2500), (100, 64)):
        xr = torch.randn(r, cc, generator=gen, device=dev).to(torch.bfloat16)

        def fill(xr=xr, r=r, cc=cc):
            xc.zero_()[:r, :cc] = xr

        cases.append(({"r": r, "c": cc}, fill, cs.colsum_plain(xr),
                      lambda out, cc=cc: out[:cc]))
    buckets["colsum"] = bucketed(
        ak.name, c_disp, cdrv,
        lambda D: ops.blocked_colsum(xc, in_graph=c_disp, dims=D), cases)
    del xc, cases
    for name, key in (("matmul", "matmul"), ("flash", "flash_attention"),
                      ("layernorm", "layernorm"), ("colsum", "colsum")):
        errs[key] = buckets[name]["max_abs_err"]
    registry.clear()
    torch.cuda.empty_cache()

    print(f"  (b) wall {time.perf_counter() - t_part:.2f} s", flush=True)

    # -- (c) the async front-end and chunked prefill -----------------------
    t_part = time.perf_counter()
    cfg, params = llama
    V = cfg.vocab_size

    def prompts(lens, base):
        return [[2 + (7 * (i + base) + j) % (V - 4) for j in range(L)]
                for i, L in enumerate(lens)]

    print(f"  (c) llama3.2-1b, the async front-end against the synchronous "
          f"loop (bench_serving's engine stage) on one engine: batch "
          f"{ASYNC_BATCH}, max_seq {ASYNC_MAX_SEQ}, {len(ASYNC_LENS)} prompt "
          f"lengths {ASYNC_LENS[0]}-{ASYNC_LENS[-1]}, {ASYNC_MAX_NEW} new "
          f"tokens each, prefill_chunk {ASYNC_CHUNK}, every request greedy; "
          f"first a {2 * ASYNC_CHUNK}-token prompt and three others (every "
          f"chunk size: the captures), then async, sync, and async "
          f"prefilling through the decode graph once per prompt token "
          f"(the chunk graphs' alternative)", flush=True)
    engine = build_engine(cfg, batch=ASYNC_BATCH, max_seq=ASYNC_MAX_SEQ,
                          params=params, seed=SEED, prefill_chunk=ASYNC_CHUNK)

    def per_token(slot, prompt):
        """Prefill through the decode graph, one replay per prompt token."""
        for t_idx, tok in enumerate(prompt[:-1]):
            engine._single(slot, tok, t_idx)

    def serve(run, lens, base, new=ASYNC_MAX_NEW):
        engine.finished.clear()
        for i, p in enumerate(prompts(lens, base)):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=new))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = sum(len(r.output) for r in done)
        return {"requests": len(done), "tokens": toks, "wall_s": wall,
                "tok_s": toks / wall,
                "outputs": {r.rid: list(r.output) for r in done}}

    first = serve(engine.run_async,
                  [2 * ASYNC_CHUNK] + list(ASYNC_LENS[:ASYNC_BATCH - 1]),
                  1000)
    print(f"    the first prompts, with every capture: "
          f"{first['wall_s']:.3f} s", flush=True)
    _print_captures(engine)
    serving = {"first_s": first["wall_s"],
               "captures": [{"step": name, "capture_s": st.capture_s,
                             "record_s": st.record_s,
                             "pool_bytes": st.pool_bytes}
                            for name, st in [("decode", engine._decode)]
                            + [(f"chunk {c}", st) for c, st in
                               sorted(engine._chunks.items())]]}
    outputs = {}
    for mode, run in (("async", engine.run_async), ("sync", engine.run),
                      ("async, per token", engine.run_async)):
        if mode == "async, per token":
            engine._prefill_chunked = per_token
        r = serve(run, ASYNC_LENS, 0)
        engine.__dict__.pop("_prefill_chunked", None)
        outputs[mode] = r.pop("outputs")
        serving[mode] = r
        print(f"    {mode}: {r['requests']} requests, {r['tokens']} tokens "
              f"in {r['wall_s']:.3f} s, {r['tok_s']:.2f} tok/s", flush=True)
    ratio = serving["async"]["tok_s"] / serving["sync"]["tok_s"]
    chunk_gain = (serving["async"]["tok_s"]
                  / serving["async, per token"]["tok_s"])
    same = outputs["async"] == outputs["sync"] == outputs["async, per token"]
    cc = dict(engine.compile_counts)
    print(f"    async / sync tok/s {ratio:.2f} (the JAX bench's bar on its "
          f"own path: {ASYNC_RATIO_BAR}, printed, not gated); chunk graphs / "
          f"the decode graph per prompt token {chunk_gain:.2f}; greedy "
          f"tokens equal: {same}; {cc}", flush=True)
    if len(outputs["async"]) != len(ASYNC_LENS) or not same:
        raise AssertionError("async tokens differ from the sync engine's")
    if cc["decode_step"] != 1 or not 1 <= cc["prefill_chunk"] <= 6:
        raise AssertionError(f"async compile_counts {cc}")
    # a re-plan drops every graph: the next prompt waits for the captures
    warm = serve(engine.run_async, [2 * ASYNC_CHUNK], 2000, new=1)
    registry.note_override("matmul_b16", hw.name, {"m": 1, "n": 1, "k": 1},
                           ops.MATMUL_DEFAULT)
    stall = serve(engine.run_async, [2 * ASYNC_CHUNK], 2000, new=1)
    cc2 = dict(engine.compile_counts)
    print(f"    one {2 * ASYNC_CHUNK}-token prompt to its first token: warm "
          f"{warm['wall_s']:.3f} s, right after a re-plan (an override "
          f"pinned) {stall['wall_s']:.3f} s; {cc} -> {cc2}", flush=True)
    _print_captures(engine)
    if stall["outputs"] != warm["outputs"] or \
            cc2 != {"decode_step": 2, "prefill_chunk": cc["prefill_chunk"]
                    + len(engine._pow2_chunks(2 * ASYNC_CHUNK - 1,
                                              ASYNC_CHUNK))}:
        raise AssertionError("the re-plan did not re-capture every step, "
                             "or changed the tokens")
    serving.update(tok_s_ratio=ratio, chunk_graph_gain=chunk_gain,
                   compile_counts=cc, replan_warm_s=warm["wall_s"],
                   replan_stall_s=stall["wall_s"])
    note(engine.graph_launches())
    del engine, llama, params
    gc.collect()
    registry.clear()
    torch.cuda.empty_cache()
    print(f"  (c) wall {time.perf_counter() - t_part:.2f} s", flush=True)

    # -- (d) plans in the engine -------------------------------------------
    t_part = time.perf_counter()
    registry.clear()
    cfg, params = qwen["cfg"], qwen["params"]
    engine = build_engine(
        cfg, batch=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ, params=params,
        seed=SEED,
        plan_envelope=default_plan_envelope(ENGINE_SLOTS, ENGINE_MAX_SEQ),
        bucket_lattices=default_bucket_lattices(cfg, ENGINE_SLOTS,
                                                ENGINE_MAX_SEQ))
    ws, ps = engine.warm_started, engine.plan_summary
    plan = engine._step_plan
    print(f"  (d) {QWEN_ARCH} ({QWEN_LAYERS} layers) with "
          f"plan_envelope=default_plan_envelope({ENGINE_SLOTS}, "
          f"{ENGINE_MAX_SEQ}) and default_bucket_lattices: warm start "
          f"{list(ws)} (plans {ws.plans_loaded}); launch plans "
          f"{ps['compiled']} compiled, {ps['loaded']} loaded, "
          f"{ps['skipped']} skipped, {ps['entries']} entries; step plan "
          f"{plan.describe()}", flush=True)
    for (kernel, D), cfg_k in sorted(plan.table.items()):
        print(f"      {kernel} {dict(D)}: {cfg_k} "
              f"({plan.sources[(kernel, D)]})")
    if "moe_gmm_b16" not in ws:
        raise AssertionError("the engine's warm start did not load phase "
                             "16's moe_gmm_b16 driver")
    stats, memo, hits = (registry.stats(), registry.memo_size(),
                         registry.memo_hits())
    rng = np.random.RandomState(SEED + 1)

    def serve(rids):
        for i in rids:
            engine.submit(Request(rid=i, prompt=[
                int(t) for t in rng.randint(2, cfg.vocab_size, size=4)],
                max_new_tokens=4))
        return engine.run()

    done = serve(range(4))
    calls = engine.steps + 4 * 3
    moved = (registry.stats() != stats or registry.memo_size() != memo
             or registry.memo_hits() != hits)
    print(f"      {calls} decode-step calls: registry stats, memo size and "
          f"memo hits unchanged: {not moved}; {engine.compile_counts}; "
          f"bucket stats {engine.bucket_stats}", flush=True)
    if calls < 16 or moved or len(done) != 4:
        raise AssertionError("the registry moved under the step plan, or "
                             "the traffic did not run")
    before = engine.compile_counts["decode_step"]
    key = next(k for k in plan.table if k[0] == "moe_gmm_b16"
               and dict(k[1])["g"] == 64)
    pinned = next({"bg": t[0], "bn": t[1], "bk": t[2]} for t in
                  ((64, 128, 64), (64, 64, 64))
                  if {"bg": t[0], "bn": t[1], "bk": t[2]} != plan.table[key])
    registry.note_override(key[0], registry.hw_name(key[0]), dict(key[1]),
                           pinned)
    done = serve(range(4, 6))
    after = engine.compile_counts["decode_step"]
    print(f"      override {pinned} pinned at {dict(key[1])}: decode "
          f"captures {before} -> {after}; step plan now "
          f"{engine._step_plan.describe()['sources']}; {len(done)} requests "
          f"finished", flush=True)
    _print_captures(engine)
    if after != before + 1 or engine._step_plan.table[key] != pinned \
            or sorted(r.rid for r in done) != list(range(6)) \
            or not all(r.done for r in done):
        raise AssertionError("the pinned override did not re-capture the "
                             "decode step, or its requests did not finish")
    note(engine.graph_launches())
    plans = {"warm_started": list(ws), "plan_summary": ps,
             "step_plan": plan.describe(), "recaptured": after - before,
             "bucket_stats": dict(engine.bucket_stats)}
    del engine
    gc.collect()
    registry.clear()

    print(f"  (d) wall {time.perf_counter() - t_part:.2f} s", flush=True)

    # -- (e) this path's launches ------------------------------------------
    launches = {k: c.count + graphed.get(k, 0)
                for k, c in LAUNCH_COUNTERS.items()}
    print(f"  launches on this path (eager calls + graph replays x launches "
          f"per replay): {launches}; by graph replays: {graphed}",
          flush=True)
    for k in ("matmul", "flash_attention", "moe_gmm", "layernorm", "colsum"):
        if not launches[k]:
            raise AssertionError(f"{k} never launched on the phase-23 path")
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(23)
    print(json.dumps({"engine": {
        "decode": decode_rows, "buckets": buckets, "serving": serving,
        "plans": plans, "launches": launches, "graph_launches": graphed,
        "card": card}}))
    return {"launches": launches, "graphed": graphed, "max_abs_err": errs}


# Phase 24: the JAX package's other architectures that fit one card, at the
# full width of their configs with seeded random weights: (arch, layers on
# the card or None for the config's all, tokens of the prefill, its prefix
# rows: patch embeddings of a vlm, frame embeddings of an encdec).  grok-1
# and internvl2 are cut in depth (2 of 64 layers, about 22.9 GB, whose
# plain-kernel step takes most of the phase's time; 16 of 80, about 31.6 GB
# to fit the card beside the run's other buffers); gemma2
# prefills its context length, 8192, so that its 4096-token windows mask;
# whisper its 448-token decoder context after the encoder's 1500 frames.
# jamba-1.5-large does not fit: one period of 8 layers is about 90 GB.
ARCH_RUNS = (
    ("grok-1-314b", 2, PREFILL_S, 0),
    ("qwen3-14b", None, PREFILL_S, 0),
    ("internlm2-1.8b", None, PREFILL_S, 0),
    ("gemma2-2b", None, 8192, 0),
    ("internvl2-76b", 16, PREFILL_S - 256, 256),
    ("whisper-medium", None, 448, 1500),
)
ARCH_PROFILE_GROUPS = (
    ("grouped matmul", ("gemm_sm90::",)),
    ("flash", ("flash_",)),
    ("cuBLAS", GEMM_NAMES),
)
ARCH_REQUESTS, ARCH_MAX_NEW = 4, 8
EMBED_STD = 0.02           # the embedding table's init std


def _fan_in_scaled(model, params: dict) -> None:
    """Rescale, in place, every stacked "scaled" leaf of ``params`` to std
    1 / sqrt(its fan-in).  The reference's init takes the stack's depth as
    the fan-in; at that std attention is near one-hot and two correct bf16
    steps drift apart with depth beyond the logit gate (whisper's by 0.9 of
    max |logit|)."""
    from repro_torch.models import spec_leaves
    for path, spec in spec_leaves(model.specs()):
        if spec.init == "scaled" and spec.axes[:1] == ("layers",):
            leaf = functools.reduce(dict.__getitem__, path.split("/"),
                                    params)
            leaf.mul_(spec.shape[-2] ** -0.5 / spec.std())


def _attn_label(cfg, kw: dict, sq: int, skv: int) -> str:
    if cfg.arch_kind == "encdec":
        return ("decoder self" if kw["causal"] else
                "encoder" if sq == skv else "cross")
    if kw.get("window") is not None:
        return f"local (window {kw['window']})"
    return "global" if cfg.period > 1 else "self"


def archs_phase(dev, hw, check, time_ms, phase_done, caches, card: str,
                drivers: list) -> dict:
    """Phase 24: grok-1, qwen3-14b, internlm2-1.8b, gemma2-2b, internvl2-76b
    and whisper-medium on the card (see the module docstring).  ``drivers``
    are the drivers earlier phases built (registered here); a
    ``flash_attn_d256_causal`` driver is built and read back through the
    driver cache.  Returns this path's launches and the flash and grouped
    matmul rows at each architecture's layer shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import (CudaEventTimer, Klaraptor,
                                  flash_attention_spec, flash_probe_data,
                                  get_driver, register_driver, registry,
                                  selection_ratio)
    from repro_torch.core.kernel_spec import flash_uses_sm90
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops
    from repro_torch.launch import build_engine, make_prefill_step
    from repro_torch.models import Model
    from repro_torch.serving import Request, greedy

    print(f"[24] the remaining architectures on the card ({card}): "
          f"prefill at full width (seeded weights at std 1/sqrt(fan-in)) "
          f"and the graphed engine, then the prefill with the plain kernels "
          f"(logits gate {LOGIT_REL_TOL:g} x max|logit|)", flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    peak_before = torch.cuda.max_memory_allocated(dev)
    print(f"  memory: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated at the start (phase 22's qwen3-moe freed); peak of "
          f"phases 1-23 {peak_before / 1e9:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)

    # the drivers: those earlier phases built, and one for head dim 256
    # (gemma2's), built as phase 8 builds head dim 64's, written through
    # the driver cache and read back from it
    fresh_cache(caches)
    registry.clear()
    t0 = time.perf_counter()
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    spec256 = flash_attention_spec(256, causal=True, dtype_bytes=2)
    build = Klaraptor(timer).build_driver(
        spec256, probe_data=flash_probe_data(), repeats=2,
        max_configs_per_size=12)
    registry.clear()
    for drv in drivers:
        register_driver(drv)
    drv256 = get_driver(spec256.name, spec256, hw)
    if drv256 is None or drv256.source_hash != build.driver.source_hash:
        raise AssertionError("the d 256 driver did not read back from the "
                             "driver cache")
    cols = build.collected.columns
    if int(cols["bh"].max()) > 64 or int(cols["sq"].max()) > 1024:
        raise AssertionError("d 256 probes left bh <= 64, sq <= 1024")
    print(f"  drivers: {sorted(d.kernel for d in drivers)} from earlier "
          f"phases; {spec256.name} built on the card in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({build.collected.n_probe_executions} probe executions at "
          f"bh <= 64, sq = skv <= 1024) and read back through the driver "
          f"cache", flush=True)
    print("  " + build.fit_report().replace("\n", "\n  "), flush=True)

    counters = {"flash_attention": flash.LAUNCHES, "moe_gmm": gmm.LAUNCHES}
    launches = {k: 0 for k in counters}
    graphed_total: dict[str, int] = {}
    rows: dict[str, dict] = {}
    flash_rows: list[dict] = []
    gmm_rows: list[dict] = []
    worst = {"flash_attention": 0.0, "moe_gmm": 0.0}
    ratio256 = None

    def run_arch(arch: str, n_layers: int | None, n_tok: int,
                 n_prefix: int) -> None:
        """One architecture: its path (the tuned prefill and the engine),
        then, after its counters are read, the comparisons with the eager
        decode step and the plain-kernel prefill, and its layer shapes
        timed at the tiles the path launched.  Every tensor it makes is
        freed when it returns."""
        nonlocal ratio256
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        V = cfg.vocab_size
        model = Model(cfg)
        params = model.init(SEED)
        _fan_in_scaled(model, params)
        torch.cuda.synchronize()
        total_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(params))
        # what a decode step reads: every weight but the encoder's and the
        # embedding table, of which it gathers one row per sequence (a tied
        # head reads the whole table)
        weight_bytes = total_bytes - sum(
            t.numel() * t.element_size()
            for t in _leaves(params.get("encoder", {})))
        if not cfg.tie_embeddings:
            weight_bytes -= params["embed"].numel() * 2
        agen = torch.Generator(device=dev).manual_seed(SEED)
        tokens = torch.randint(0, V, (1, n_tok), generator=agen, device=dev)
        extra = {}
        if n_prefix:
            prefix = (torch.randn(1, n_prefix, cfg.d_model, generator=agen,
                                  device=dev) * EMBED_STD).to(cfg.dtype)
            extra = {"patches" if cfg.arch_kind == "vlm" else "frames":
                     prefix}
        attn_layers = sum(d.kind == "attn" for d in cfg.block_pattern) \
            + sum(d.cross_attn for d in cfg.block_pattern)
        want = {"flash_attention": attn_layers * cfg.n_groups
                + (cfg.encoder_layers if cfg.arch_kind == "encdec" else 0),
                "moe_gmm": 3 * cfg.n_groups * sum(
                    d.moe for d in cfg.block_pattern)}
        depth = ("" if n_layers is None else
                 f", {n_layers} of {get_config(arch).n_layers} layers")
        what = "patch" if cfg.arch_kind == "vlm" else "frame"
        inp = (f"B 1 x ({n_prefix} {what} embeddings + {n_tok} tokens)"
               if n_prefix else f"B 1 x S {n_tok}")
        print(f"  {arch} ({cfg.arch_kind}): d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"
              + (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
                 f"{cfg.moe_d_ff}" if cfg.n_experts else
                 f", d_ff {cfg.d_ff}")
              + (f", softcaps {cfg.attn_softcap} / {cfg.final_softcap}"
                 if cfg.attn_softcap else "")
              + f", vocab {V}{depth}: {total_bytes / 1e9:.2f} GB of bf16 "
              f"weights; prefill {inp}", flush=True)

        # -- the path: the tuned prefill and the engine ---------------------
        for c in counters.values():
            c.reset()
        step = make_prefill_step(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, tokens, **extra)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        per_step = {k: c.count for k, c in counters.items()}
        if per_step != want:
            raise AssertionError(f"{arch}: the prefill launched {per_step}, "
                                 f"not {want}")
        if tuple(logits.shape) != (1, cfg.padded_vocab) \
                or not bool(torch.isfinite(logits[:, :V]).all()):
            raise AssertionError(f"{arch}: prefill logits {logits.shape} "
                                 f"not finite")
        t0 = time.perf_counter()
        step(params, tokens, **extra)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        prof = _device_profile(lambda: step(params, tokens, **extra),
                               f"one {arch} prefill step",
                               groups=ARCH_PROFILE_GROUPS, cpu=False)

        engine = build_engine(cfg, batch=ENGINE_SLOTS,
                              max_seq=ENGINE_MAX_SEQ, params=params,
                              seed=SEED)
        rng = np.random.RandomState(SEED)
        prompts = [[int(t) for t in rng.randint(2, V, size=6 + 2 * i)]
                   for i in range(ARCH_REQUESTS)]
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p,
                                  max_new_tokens=ARCH_MAX_NEW))
        before_gmm = gmm.LAUNCHES.count
        done = engine.run()
        graphed = engine.graph_launches()
        calls = engine.steps + sum(len(p) - 1 for p in prompts)
        engine_gmm = gmm.LAUNCHES.count - before_gmm \
            + graphed.get("moe_gmm", 0)
        if sorted(r.rid for r in done) != list(range(ARCH_REQUESTS)) \
                or not all(r.done and 1 <= len(r.output) <= ARCH_MAX_NEW
                           for r in done):
            raise AssertionError(f"{arch}: not every request finished")
        if engine.compile_counts["decode_step"] != 1:
            raise AssertionError(f"{arch}: {engine.compile_counts}")
        if engine_gmm != want["moe_gmm"] * calls:
            raise AssertionError(f"{arch}: {engine_gmm} grouped-matmul "
                                 f"launches in {calls} decode steps")
        tok = np.arange(ENGINE_SLOTS, dtype=np.int32) + 5
        pos = np.arange(ENGINE_SLOTS, dtype=np.int32) + 64
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in engine.cache.items()}
        got = engine._run_step(tok, pos)[:, :V].clone()

        def graphed_call():
            return greedy(engine._run_step(tok, pos)).cpu()

        graphed_call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_CALLS):
            graphed_call()
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / DECODE_CALLS * 1e3
        dprof = _device_profile(
            lambda: [graphed_call() for _ in range(DECODE_CALLS)],
            f"{arch}, {DECODE_CALLS} graphed decode calls",
            groups=ARCH_PROFILE_GROUPS, cpu=False)
        decode_device_ms = (dprof["busy_ms"] / DECODE_CALLS if dprof
                            else None)
        graphed = engine.graph_launches()
        for k, c in counters.items():        # this architecture's path ends
            launches[k] += c.count + graphed.get(k, 0)
            graphed_total[k] = graphed_total.get(k, 0) + graphed.get(k, 0)
        tiles = {k: dict(c.tiles) for k, c in counters.items()}

        # -- after the counters are read: the eager decode step on the
        # graphed call's cache, and the prefill with the plain kernels -----
        for k, v in saved.items():
            for n, t in v.items():
                engine.cache[k][n].copy_(t)
        eager, _ = model.decode_step(params, torch.as_tensor(tok, device=dev),
                                     torch.as_tensor(pos, device=dev),
                                     engine.cache)
        gdiff = float((got - eager[:, :V]).abs().max())
        bound_ms = weight_bytes / HBM_BW * 1e3
        print(f"    engine: {ENGINE_SLOTS} slots, max_seq {ENGINE_MAX_SEQ}, "
              f"{len(done)} of {ARCH_REQUESTS} requests finished ({calls} "
              f"decode-step calls); graphed {decode_ms:.3f} ms per call "
              f"(step + greedy tokens to the host; device "
              + (f"{decode_device_ms:.3f} ms" if decode_device_ms is not None
                 else "time not measured")
              + ") against a weight-read "
              f"bound of {bound_ms:.3f} ms ({weight_bytes / 1e9:.2f} GB at "
              f"{HBM_BW / 1e12:.2f} TB/s); graphed vs eager logits "
              f"max|diff| {gdiff:.4e} (bit-equal: {gdiff == 0.0}); "
              f"grouped-matmul launches {engine_gmm}", flush=True)
        _print_captures(engine)
        if gdiff != 0.0:
            raise AssertionError(f"{arch}: graphed logits differ from the "
                                 f"eager step's")
        del engine, saved, eager, got
        gc.collect()
        torch.cuda.empty_cache()

        recorded: dict = {}
        rec_gmm: list = []

        def plain_attn(q, k, v, **kw):
            key = (kw["causal"], kw.get("window"), q.shape[1], k.shape[1])
            recorded.setdefault(key, (q, k, v, kw))
            return flash.flash_attention_plain(q, k, v, **kw)

        def plain_gmm(x, w):
            if len(rec_gmm) < 3:
                rec_gmm.append((x, w))
            return gmm.moe_gmm_plain(x, w)

        t0 = time.perf_counter()
        ref = make_prefill_step(model, attn_op=plain_attn,
                                gmm_op=plain_gmm)(params, tokens, **extra)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        scale = float(ref[:, :V].abs().max())
        diff = float((logits[:, :V] - ref[:, :V]).abs().max())
        agree = int(greedy(logits)[0]) == int(greedy(ref)[0])
        capped = float(logits[:, :V].abs().max())
        print(f"    prefill: first {first_ms:.2f} ms, warm {warm_ms:.2f} ms "
              f"wall; launches {per_step} (gated); logits vs the plain "
              f"step ({plain_s:.2f} s wall): max|diff| {diff:.4e}, "
              f"max|logit| {scale:.4e}, ratio {diff / scale:.3e} (gated at "
              f"{LOGIT_REL_TOL:g}); argmax agrees: {agree}"
              + (f"; max|logit| {capped:.4f} within the final softcap "
                 f"{cfg.final_softcap}" if cfg.final_softcap else ""),
              flush=True)
        if not diff <= LOGIT_REL_TOL * scale:
            raise AssertionError(f"{arch}: logits disagree with the plain "
                                 f"step")
        if cfg.final_softcap and not capped <= cfg.final_softcap:
            raise AssertionError(f"{arch}: a logit beyond the final softcap")
        del ref, logits
        torch.cuda.empty_cache()

        # -- each distinct attention launch, at the tiles the path took --
        for (causal, window, sq, skv), (q, k, v, kw) in recorded.items():
            heads = dict(num_q_heads=kw["num_q_heads"],
                         num_kv_heads=kw["num_kv_heads"])
            fkw = dict(causal=causal, window=window, softcap=kw["softcap"],
                       **heads)
            d = q.shape[2]
            D = {"bh": q.shape[0], "sq": sq, "skv": skv}
            fcfg = tiles["flash_attention"][(D["bh"], sq, skv, d, causal)]
            plain = flash.flash_attention_plain(
                q, k, v, q_chunk=cfg.attn_chunk, **fkw)
            label = _attn_label(cfg, kw, sq, skv)
            err = check(flash.flash_attention_kernel(q, k, v, **fcfg, **fkw),
                        plain, torch.bfloat16, f"{arch} {label}",
                        quiet=True)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            pairs = _visible_pairs(sq, skv, causal, window)
            bound, bound_by = _flash_bound_ms(D["bh"], sq, skv, k.shape[0],
                                              d, causal, 2, window)
            library = None
            if window is None and kw["softcap"] is None:
                q4 = q.view(1, heads["num_q_heads"], sq, d)
                k4 = k.view(1, heads["num_kv_heads"], skv, d)
                v4 = v.view(1, heads["num_kv_heads"], skv, d)
                library = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True))
            r = {
                "arch": arch, "attention": label,
                "shape": f"bh {D['bh']} (GQA {heads['num_q_heads']}/"
                         f"{heads['num_kv_heads']}), sq {sq}, skv {skv}, "
                         f"d {d}",
                "causal": causal, "window": window, "softcap": kw["softcap"],
                "body": "wgmma" if flash_uses_sm90(d, 2) else "SIMT",
                "config": fcfg, "max_abs_err": err,
                "ms": time_ms(lambda: flash.flash_attention_kernel(
                    q, k, v, **fcfg, **fkw)),
                "default_ms": time_ms(lambda: flash.flash_attention_kernel(
                    q, k, v, **ops.FLASH_DEFAULT, **fkw)),
                "library_ms": library,
                "plain_ms": time_ms(lambda: flash.flash_attention_plain(
                    q, k, v, q_chunk=cfg.attn_chunk, **fkw), max_iters=1),
                "bound_ms": bound, "bound_by": bound_by,
            }
            r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
            r["tflops"] = 4.0 * d * D["bh"] * pairs / (r["ms"] * 1e-3) / 1e12
            if arch == "gemma2-2b" and ratio256 is None:
                ratio256 = selection_ratio(spec256, timer, drv256, D, hw)
                r["selection_ratio"] = ratio256["ratio"]
            flash_rows.append(r)
            lib = ("none (no SDPA call has its window or softcap)"
                   if library is None else f"{library:.4f} ms")
            print(f"    flash {label}: {r['shape']}"
                  + (f", window {window}" if window else "")
                  + (f", softcap {kw['softcap']}" if kw["softcap"] else "")
                  + f", {r['body']} body: {fcfg} {r['ms']:.4f} ms "
                  f"({r['tflops']:.2f} TFLOP/s, {r['pct_of_bound']:.1f} % "
                  f"of bound) | default {r['default_ms']:.4f} ms | SDPA "
                  f"{lib} | plain {r['plain_ms']:.2f} ms | bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | max_abs_err "
                  f"{err:.3e}", flush=True)
        if rec_gmm:
            (xe, wg), _, (hh, wd) = rec_gmm
            for label, x, w in (("prefill gate/up", xe, wg),
                                ("prefill down", hh, wd),
                                ("decode gate/up", xe[:, :8].contiguous(), wg),
                                ("decode down", hh[:, :8].contiguous(), wd)):
                e, g, kk = x.shape
                n = w.shape[2]
                Dg = ops.gemm_dims("moe_gmm_b16",
                                   {"e": e, "g": g, "k": kk, "n": n})
                gkey = (e, Dg["g"], Dg["k"], Dg["n"])
                gcfg = tiles["moe_gmm"][gkey]
                # at the output's scale, the form of phase 22 (c): against
                # torch.bmm, and against the plain version on the first rows
                # of each expert (all of a decode step's 8; all 1280 would
                # take the plain version seconds)
                def at_scale(out, ref, what):
                    out, ref = out.float(), ref.float()
                    diff = (out - ref).abs()
                    if not bool(torch.isfinite(out).all()) or not bool(
                            (diff <= 2e-2 * (float(ref.abs().max())
                                             + ref.abs())).all()):
                        raise AssertionError(f"{arch} {label}: the grouped "
                                             f"matmul disagrees with {what}")
                    return float(diff.max()), float(ref.abs().max())

                err, gscale = at_scale(ops.moe_gmm(x, w), torch.bmm(x, w),
                                       "torch.bmm")
                xs = x[:, :min(g, 64)].contiguous()
                perr, _ = at_scale(ops.moe_gmm(xs, w),
                                   gmm.moe_gmm_plain(xs, w), "plain")
                worst["moe_gmm"] = max(worst["moe_gmm"], perr)
                t_ops = 2.0 * e * g * kk * n / PEAK_BF16
                t_bytes = (e * g * kk + e * kk * n + e * g * n) * 2 / HBM_BW
                r = {"arch": arch, "shape": label, "e": e, "g": g, "k": kk,
                     "n": n, "padded_g": Dg["g"], "config": gcfg,
                     "max_abs_err_vs_bmm": err, "max_abs_err": perr,
                     "plain_rows": xs.shape[1],
                     "ms": time_ms(lambda: ops.moe_gmm(x, w)),
                     "library_ms": time_ms(lambda: torch.bmm(x, w)),
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": ("operations" if t_ops >= t_bytes
                                  else "bytes")}
                if gmm.LAUNCHES.tiles[gkey] != gcfg:
                    raise AssertionError(f"{arch} {label}: timed at "
                                         f"{gmm.LAUNCHES.tiles[gkey]}, the "
                                         f"path launched {gcfg}")
                r["pct_of_bound"] = 100.0 * r["bound_ms"] / r["ms"]
                gmm_rows.append(r)
                print(f"    grouped matmul {label} (e {e}, g {g} -> "
                      f"{Dg['g']}, k {kk}, n {n}): {gcfg} {r['ms']:.4f} ms "
                      f"({r['pct_of_bound']:.1f} % of bound) | torch.bmm "
                      f"{r['library_ms']:.4f} ms | bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | vs "
                      f"torch.bmm max_abs_err {err:.3e} at max|out| "
                      f"{gscale:.4e} (tol 2e-2 of it); vs plain on "
                      f"{xs.shape[1]} rows per expert {perr:.3e} (the plain "
                      f"version takes seconds a call here: not timed)",
                      flush=True)
                del xs
        peak = torch.cuda.max_memory_allocated(dev)
        rows[arch] = {
            "layers": cfg.n_layers, "weights_gb": total_bytes / 1e9,
            "prefill_input": inp, "prefill_first_ms": first_ms,
            "prefill_warm_ms": warm_ms, "launches_per_prefill": per_step,
            "prefill_busy": (prof["busy_ms"] / prof["wall_ms"]
                             if prof else None),
            "prefill_device_ms": prof.get("busy_ms") if prof else None,
            "logit_ratio": diff / scale, "argmax_agrees": agree,
            "decode_device_ms": decode_device_ms,
            "plain_step_s": plain_s, "decode_ms_per_call": decode_ms,
            "decode_weight_bound_ms": bound_ms,
            "decode_calls": calls, "peak_gb": peak / 1e9,
            "wall_s": time.perf_counter() - t_arch,
        }
        print(f"    {arch}: peak memory {peak / 1e9:.2f} GB; wall "
              f"{rows[arch]['wall_s']:.2f} s", flush=True)

    for run in ARCH_RUNS:
        run_arch(*run)
        gc.collect()          # an engine and its graphs form a cycle
        torch.cuda.empty_cache()

    if ratio256 is not None:
        print(f"  [after the path] {spec256.name} selection ratio at "
              f"{ratio256['D']} (exhaustive: 1 warm-up + median of 3 timed "
              f"launches per candidate; printed, not gated): chosen "
              f"{ratio256['chosen']} {ratio256['chosen_time_s'] * 1e3:.4f} "
              f"ms, best {ratio256['best']} "
              f"{ratio256['best_time_s'] * 1e3:.4f} ms of "
              f"{ratio256['n_configs']}, ratio {ratio256['ratio']:.3f}",
              flush=True)
    print(f"  launches on this path (eager calls + graph replays x launches "
          f"per replay): {launches}; by graph replays: {graphed_total}; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
          flush=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the phase-24 path never "
                             f"launched: {launches}")
    registry.clear()
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(24)
    print(json.dumps({"archs": {"models": rows, "flash": flash_rows,
                                "moe_gmm": gmm_rows,
                                "flash_d256_selection": ratio256,
                                "launches": launches, "card": card}}))
    return {"launches": launches, "flash_attention": flash_rows,
            "moe_gmm": gmm_rows, "max_abs_err": worst}


def search_phase(hw, phase_done, caches: list, gmm32_pass) -> dict:
    """Phase 25: KLARAPTOR's budgeted online search on the card (see the
    module docstring).  Returns the path's launches of the f32 matmul and
    grouped matmul."""
    import numpy as np

    from repro_torch.benchmarks.bench_search import (BUDGET_FRACTION,
                                                     GOOD_RATIO, score)
    from repro_torch.core import (CudaEventTimer, Klaraptor, exhaustive_pass,
                                  matmul_spec, moe_gmm_spec)
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.search import STRATEGIES, SearchBudget, default_budget

    print("[25] KLARAPTOR's budgeted online search on the card: run_search "
          "with each strategy on the f32 SIMT kernels", flush=True)
    t_phase = time.perf_counter()
    timer = CudaEventTimer(hw, warmup=1, timings=3, seed=SEED)
    mm_spec, mm_D = matmul_spec(4), {"m": SEARCH_N, "n": SEARCH_N,
                                     "k": SEARCH_N}
    _, k, n = GMM_SHAPES[0]
    # the matmul's exhaustive pass times every tile, so it runs before the
    # path's counters start, as phase 16's pass of the grouped matmul does
    t0 = time.perf_counter()
    mm_pass = exhaustive_pass(mm_spec, timer, mm_D, hw)
    mm_wall = time.perf_counter() - t0
    cases = ((mm_spec, mm_D, mm_pass, f"{mm_wall:.2f} s wall"),
             (moe_gmm_spec(4), {"e": GMM_E, "g": GMM_G, "k": k, "n": n},
              gmm32_pass, "phase 16's"))
    mm.LAUNCHES.reset()
    gmm.LAUNCHES.reset()                # this phase's path starts
    rows, passes = [], {}
    for spec, D, (table, times), origin in cases:
        feasible = [table.row(i) for i in range(len(table))]
        passes[spec.name] = (feasible, times)
        total, best = float(np.sum(times)), int(np.argmin(times))
        print(f"  (a) {spec.name} at {D}: one exhaustive pass over "
              f"{len(table)} tiles (1 warm-up + median of 3 timed launches "
              f"each; {origin}): best {feasible[best]} "
              f"{times[best] * 1e3:.4f} ms; summed medians (the exhaustive "
              f"device-seconds) {total:.4f} s", flush=True)
        runs = [(name, f"{BUDGET_FRACTION:.0%} of them",
                 SearchBudget(max_device_seconds=BUDGET_FRACTION * total))
                for name in sorted(STRATEGIES)]
        runs.append(("random", "default_budget",
                     default_budget(len(table))))
        for name, what, budget in runs:
            r = score(spec, timer, D, hw, times, name, budget, SEED)
            cap_e, cap_s = budget.max_executions, budget.max_device_seconds
            r["budget_label"] = what
            r["wall_per_device_second"] = r["search_wall_seconds"] / max(
                r["probe_device_seconds"], 1e-300)
            rows.append(r)
            chosen = r["chosen"]
            print(f"    {name:>18} under {what}"
                  f" ({cap_e if cap_e is not None else cap_s:.6g}"
                  f"{' executions' if cap_e is not None else ' s'}): "
                  f"chosen {chosen} ratio {r['ratio']:.3f}; executions "
                  f"{r['n_probe_executions']}, device-seconds "
                  f"{r['probe_device_seconds']:.4f} "
                  f"({r['device_seconds_fraction']:.3f} of exhaustive); "
                  f"wall {r['search_wall_seconds']:.3f} s "
                  f"({r['wall_per_device_second']:.2f} x the device-seconds);"
                  f" rows probed {r['n_probed_rows'] + r['n_cut_rows']}, of "
                  f"them cut after the probe {r['n_cut_rows']}", flush=True)
            if chosen is None or chosen not in feasible:
                raise AssertionError(f"{spec.name} {name} under {what}: "
                                     f"chose {chosen}, not a feasible tile")
            if cap_e is not None and r["n_probe_executions"] > cap_e or \
                    cap_s is not None and r["probe_device_seconds"] > cap_s:
                raise AssertionError(f"{spec.name} {name} under {what}: "
                                     f"spent over the budget {budget}")
        quarter = [r["ratio"] for r in rows[-len(runs):-1]]
        print(f"    best ratio within {BUDGET_FRACTION:.0%}: "
              f"{max(quarter):.3f} (the bar {GOOD_RATIO}: printed, not gated "
              f"here; the CPU tests gate it on HopperModel)", flush=True)

    # -- (b) four builds of matmul_b32, one per strategy -----------------------
    fresh_cache(caches)
    feasible, times = passes[mm_spec.name]
    print(f"  (b) Klaraptor(CudaEventTimer).build_driver({mm_spec.name}, "
          f"strategy=...) into an empty driver cache; Fig. 1 ratio at N "
          f"{SEARCH_N} against (a)'s pass", flush=True)
    first = None
    for name in sorted(STRATEGIES):
        t0 = time.perf_counter()
        b = Klaraptor(timer).build_driver(mm_spec, strategy=name)
        wall = time.perf_counter() - t0
        if b.from_cache:
            raise AssertionError(f"the {name} build hit the cache: another "
                                 f"strategy's driver was taken")
        chosen = b.driver.choose(mm_D)
        cols = b.collected.columns
        sizes = []                      # distinct tiles per probe size
        for D in dict.fromkeys(zip(*(cols[d].tolist() for d in "mnk"))):
            at = np.all([cols[d] == v for d, v in zip("mnk", D)], axis=0)
            sizes.append(len(set(zip(*(cols[p][at].tolist()
                                       for p in mm_spec.program_params)))))
        print(f"    {name:>18}: probe executions "
              f"{b.collected.n_probe_executions}, device-seconds "
              f"{b.probe_device_seconds:.4f}, build wall {wall:.2f} s; "
              f"chosen at N {SEARCH_N} {chosen}, ratio "
              f"{float(np.min(times)) / times[feasible.index(chosen)]:.3f}; "
              f"distinct tiles per probe size (first 6 of {len(sizes)}) "
              f"{sizes[:6]}", flush=True)
        if name == "successive_halving":
            print(f"      survivors carried: {sizes[0]} tiles at the first "
                  f"size, at most {max(sizes[1:])} at each later one",
                  flush=True)
            if not max(sizes[1:]) < sizes[0]:
                raise AssertionError(f"halving probed {sizes}: not fewer "
                                     f"tiles after its first size")
        first = first or (name, chosen)
    again = Klaraptor(timer).build_driver(mm_spec, strategy=first[0])
    print(f"    {first[0]} again: from_cache={again.from_cache}, probe "
          f"executions {again.collected.n_probe_executions}, chosen "
          f"{again.driver.choose(mm_D)}", flush=True)
    if not again.from_cache or again.collected.n_probe_executions or \
            again.driver.choose(mm_D) != first[1]:
        raise AssertionError("the repeated build did not hit the cache")
    launches = {"matmul_b32": mm.LAUNCHES.count,
                "moe_gmm_b32": gmm.LAUNCHES.count}    # the path ends here
    print(f"  launches on this path (the searches' and the builds' probes "
          f"and their warm-ups): {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the phase-25 path never "
                             f"launched: {launches}")

    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(25)
    print(json.dumps({"search": {"runs": rows, "launches": launches}},
                     default=str))
    return {"launches": launches, "mm_pass": passes[mm_spec.name]}


# Phase 26: the observed serving path.  The closed loop's corrupted driver
# is fitted on HopperModel over the card's parameters with three times its
# memory rate and peaks, under the card's name (the reference's
# v5p-as-v5e build, tests/test_telemetry.py::_corrupted_build).
OFF_PHYSICS_FACTOR = 3.0
ESCALATION_FRACTION = 0.25      # of phase 25's exhaustive device-seconds
ESCALATION_BAR = 0.85           # the paper's bar, printed
REFIT_BAR = 0.90                # tests/test_telemetry.py's recovery bar
TRACER_COST_BAR = 0.02          # the tracer's sync, of a graphed decode
TRACER_ROUNDS = 6


def observed_phase(hw, phase_done, caches: list, card: str,
                   mm_pass: tuple) -> dict:
    """Phase 26: the search escalation of ``choose_or_default`` and
    ``tune_for_shape``, the telemetry loop (drift, refit, hot swap) and the
    engine observed by a tracer and the telemetry loop (see the module
    docstring).  ``mm_pass`` is phase 25's exhaustive pass of
    ``matmul_b32`` at N 2048: (feasible tiles, seconds).  Returns the
    path's launches per kernel counter."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (CudaEventTimer, DriverCache, DriverProgram,
                                  HopperModel, Klaraptor,
                                  flash_attention_spec, matmul_spec,
                                  register_driver, registry,
                                  warm_start_from_cache)
    from repro_torch.core.driver import choose_or_default, set_choice_listener
    from repro_torch.kernels import ops
    from repro_torch.launch import build_engine
    from repro_torch.models import Model
    from repro_torch.search import SearchBudget
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ServingEngine, model_kernel_specs
    from repro_torch.serving.graphs import (LAUNCH_COUNTERS, StepGraph,
                                            launch_counts)
    from repro_torch.telemetry import Telemetry, TelemetryConfig
    from repro_torch.trace import Ledger, Tracer, read_ledger, set_tracer

    class CountingTimer(CudaEventTimer):
        """The card's oracle, counting its probe calls."""

        calls = 0

        def probe_rows(self, table, rng, repeats=1):
            self.calls += 1
            return super().probe_rows(table, rng, repeats)

    print(f"[26] the observed serving path on the card ({card}): "
          f"choose_or_default's search escalation, tune_for_shape, the "
          f"telemetry loop's drift -> refit -> hot swap, and the engine "
          f"under a tracer and the telemetry loop", flush=True)
    t_phase = time.perf_counter()
    feasible, times = mm_pass
    best_s, pass_s = float(np.min(times)), float(np.sum(times))
    D = {"m": SEARCH_N, "n": SEARCH_N, "k": SEARCH_N}
    spec32 = matmul_spec(4)
    default = dict(ops.MATMUL_DEFAULT_F32)

    def ratio(cfg) -> float:
        return best_s / float(times[feasible.index(cfg)])

    for c in LAUNCH_COUNTERS.values():     # the phase-26 path starts here
        c.reset()
    parts = {}
    last = [launch_counts()]

    def part_done(name: str) -> None:
        now = launch_counts()
        parts[name] = {k: now[k] - last[0][k] for k in now
                       if now[k] != last[0][k]}
        last[0] = now

    # -- (a) the search escalation ------------------------------------------
    fresh_cache(caches)
    registry.clear()
    timer = CountingTimer(hw, seed=SEED)
    budget = SearchBudget(max_device_seconds=ESCALATION_FRACTION * pass_s)
    events = []
    set_choice_listener(events.append)
    t0 = time.perf_counter()
    found = choose_or_default(spec32.name, D, default, spec=spec32,
                              device=timer, budget=budget)
    wall = time.perf_counter() - t0
    n_first = timer.calls
    again = choose_or_default(spec32.name, D, default, spec=spec32,
                              device=timer, budget=budget)
    n_again = timer.calls - n_first
    other = choose_or_default(spec32.name, D, default, spec=spec32,
                              device=timer,
                              budget=SearchBudget(max_device_seconds=0.5
                                                  * budget.max_device_seconds))
    n_other = timer.calls - n_first - n_again
    before = timer.calls
    alone = choose_or_default(spec32.name, D, default, spec=spec32)
    n_alone = timer.calls - before
    set_choice_listener(None)
    print(f"  (a) choose_or_default({spec32.name}, N {SEARCH_N}, default "
          f"{default}, spec=, device=CudaEventTimer, budget=max_device_"
          f"seconds {budget.max_device_seconds:.4f} s "
          f"({ESCALATION_FRACTION:.0%} of phase 25's pass, {pass_s:.4f} "
          f"s)): {found} in {wall:.3f} s "
          f"wall, {n_first} probe calls; ratio against the pass's best "
          f"{ratio(found):.3f} (the bar {ESCALATION_BAR}: printed, not "
          f"gated); again: {again}, {n_again} probe calls; half the budget:"
          f" {other}, {n_other} probe calls; spec= alone: {alone}, {n_alone}"
          f" probe calls; listener sources {[e.source for e in events]}",
          flush=True)
    if found not in feasible or not n_first:
        raise AssertionError(f"the escalation returned {found}")
    if again != found or n_again or not n_other or alone != default \
            or n_alone:
        raise AssertionError("the escalation's memo or opt-in misbehaved")
    if [e.source for e in events][:2] != ["search", "search_memo"]:
        raise AssertionError(f"listener sources {events}")
    # tune_for_shape past a driver of other data parameters
    mm_build = Klaraptor(HopperModel(hw, noise=0.03, seed=5), hw=hw,
                         cache=False).build_driver(
        spec32, repeats=2, max_configs_per_size=16, register=False)
    fspec = flash_attention_spec(64, causal=True)
    register_driver(DriverProgram(kernel=fspec.name,
                                  source=mm_build.driver.source,
                                  namespace=mm_build.driver.namespace,
                                  hw=hw))
    fD = {"bh": 32, "sq": PREFILL_S, "skv": PREFILL_S}
    before = timer.calls
    t0 = time.perf_counter()
    tile = ServingEngine.__new__(ServingEngine).tune_for_shape(
        fspec, fD, timer)
    print(f"    tune_for_shape({fspec.name}, {fD}) with a matmul driver "
          f"registered under its name: {tile} in "
          f"{time.perf_counter() - t0:.3f} s, {timer.calls - before} probe "
          f"calls ({len(fspec.candidates(fD, hw))} tiles, default_budget)",
          flush=True)
    if set(tile) != {"bq", "bkv"}:
        raise AssertionError(f"tune_for_shape returned {tile}")
    part_done("escalation")

    # -- (b) the closed loop: drift -> refit -> hot swap -> version 1 ------
    fresh_cache(caches)
    registry.clear()
    off = dataclasses.replace(
        hw, hbm_bw=OFF_PHYSICS_FACTOR * hw.hbm_bw,
        peak_flops_f32=OFF_PHYSICS_FACTOR * hw.peak_flops_f32,
        peak_flops_bf16=OFF_PHYSICS_FACTOR * hw.peak_flops_bf16)
    corrupted = Klaraptor(HopperModel(off, noise=0.04, seed=7), hw=off
                          ).build_driver(spec32, repeats=2,
                                         max_configs_per_size=16, seed=7)
    refit_budget = SearchBudget(max_executions=160, max_device_seconds=pass_s)
    probe_timer = CudaEventTimer(hw, seed=SEED)
    tel = Telemetry([spec32], probe_timer, seed=3, config=TelemetryConfig(
        probe_every=2, refit_budget=refit_budget)).install()
    tracer = Tracer().install()
    decisions = 0
    t0 = time.perf_counter()
    try:
        for _ in range(24):
            choose_or_default(spec32.name, D, default)
            decisions += 1
            if tel.refits:
                break
    finally:
        tel.uninstall()
        tracer.uninstall()
    loop_wall = time.perf_counter() - t0
    spans = {r["name"]: r for r in tracer.summary()}
    c = tel.counters
    print(f"  (b) a driver fitted on HopperModel at {OFF_PHYSICS_FACTOR:g}x "
          f"the card's memory rate and peaks, named {off.name}; "
          f"Telemetry([{spec32.name}], CudaEventTimer, probe_every=2, "
          f"refit_budget={refit_budget.fingerprint()}): {decisions} "
          f"decisions in {loop_wall:.3f} s wall, {c.shadow_probes_total} "
          f"shadow probes, {c.probe_device_seconds_total:.6f} device-s, "
          f"{spans.get('telemetry.shadow_probe', {}).get('total_s', 0):.4f}"
          f" s wall", flush=True)
    if len(tel.drift_events) != 1 or len(tel.refits) != 1:
        raise AssertionError(f"{len(tel.drift_events)} drift events, "
                             f"{len(tel.refits)} refits")
    drift, r = tel.drift_events[0], tel.refits[0]
    swapped = registry.get(spec32.name)
    served = choose_or_default(spec32.name, D, default)
    chosen = swapped.choose(D)
    print(f"    drift: rel_error_ewma {drift.rel_error_ewma:.3f} over "
          f"{drift.n_samples} probes (predicted {drift.predicted_s * 1e3:.4f}"
          f" ms, observed {drift.observed_s * 1e3:.4f} ms)", flush=True)
    print(f"    refit: succeeded {r.succeeded}, error {r.error}; executions "
          f"{r.total_executions} (search {r.search_executions}, fit "
          f"{r.fit_executions}, validation {r.validation_executions}) of "
          f"{refit_budget.max_executions}; device-seconds "
          f"{r.total_device_seconds:.6f} of "
          f"{refit_budget.max_device_seconds:.6f}; wall "
          f"{r.wall_seconds:.3f} s "
          f"({r.wall_seconds / max(r.total_device_seconds, 1e-300):.2f} x "
          f"the device-seconds); searched {r.searched_config}, the new "
          f"driver's choice {chosen} (ratio {ratio(chosen):.3f}), override "
          f"{r.override}; served now {served} (ratio {ratio(served):.3f}; "
          f"the reference test's bar {REFIT_BAR}: printed, not gated)",
          flush=True)
    fresh = DriverCache()
    version = fresh.latest_version(spec32.name, hw.name)
    registry.clear()
    loaded = warm_start_from_cache([spec32], hw=hw)
    read_back = registry.get(spec32.name)
    print(f"    cache: latest tuning_version {version}; a fresh registry's "
          f"warm start loads {list(loaded)} at tuning_version "
          f"{read_back.tuning_version if read_back else None}", flush=True)
    if not r.succeeded or swapped is None or \
            swapped.source == corrupted.driver.source:
        raise AssertionError("the refit swapped no driver in")
    if r.total_executions > refit_budget.max_executions or \
            r.total_device_seconds > refit_budget.max_device_seconds:
        raise AssertionError(f"the refit spent over its budget: {r}")
    if version != 1 or read_back is None or read_back.tuning_version != 1 \
            or read_back.source != swapped.source:
        raise AssertionError("a fresh registry did not read tuning_version 1")
    part_done("closed loop")

    # -- (b') a decision inside a capture defers its probe ------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(SEARCH_N, SEARCH_N, generator=gen, device="cuda")
    y = torch.randn(SEARCH_N, SEARCH_N, generator=gen, device="cuda")
    capture_tel = Telemetry([spec32], probe_timer, seed=3, cache=False,
                            config=TelemetryConfig(probe_every=1,
                                                   refit_enabled=False))
    capture_tel.install()
    try:
        step = StepGraph(lambda: ops.matmul(x, y), torch.device("cuda"))
        eager = step().clone()            # eager call, then the capture
        probes_in = capture_tel.counters.shadow_probes_total
        queued = capture_tel.deferred_total
        with torch.cuda.stream(step.stream):
            ran = capture_tel.drain_deferred()
        replay = step().clone()
    finally:
        capture_tel.uninstall()
    torch.cuda.synchronize()
    print(f"    a StepGraph over ops.matmul ({spec32.name}, N {SEARCH_N}) "
          f"with the loop installed (probe_every=1): shadow probes before "
          f"the drain {probes_in} (the eager call's), queued during the "
          f"capture {queued}, run after it {ran} (on the capture's stream);"
          f" the graph's launches per replay {step.launches}; replay "
          f"bit-equal to the eager call: {torch.equal(replay, eager)}",
          flush=True)
    if queued < 1 or ran != queued or capture_tel._deferred \
            or step.launches != {"matmul": 1} \
            or not torch.equal(replay, eager):
        raise AssertionError("a probe ran inside the capture, or the "
                             "graph does not replay the eager call")
    del step, x, y, eager, replay
    registry.clear()
    part_done("capture")

    # -- (c) the engine, observed, at full width ----------------------------
    fresh_cache(caches)
    cfg = get_config("llama3.2-1b")
    model = Model(cfg)
    params = model.init(SEED)
    rng = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab_size,
                                            size=8 + 32 * i // 7)]
               for i in range(N_REQUESTS)]
    tok = np.arange(ENGINE_SLOTS, dtype=np.int32) + 5
    pos = np.arange(ENGINE_SLOTS, dtype=np.int32) + 64
    out_dir = Path(tempfile.mkdtemp(prefix="observed-"))
    caches.append(str(out_dir))

    def serve(**kw):
        engine = build_engine(cfg, batch=ENGINE_SLOTS,
                              max_seq=ENGINE_MAX_SEQ, params=params,
                              seed=SEED, **kw)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                                  temperature=0.0 if i % 2 == 0 else 0.8))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return engine, {r.rid: list(r.output) for r in done}, wall

    def decode_ms(engine) -> float:
        """ms per graphed decode call: the step and its greedy tokens to
        the host, as phase 23 (a) times it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_CALLS):
            engine._run_step(tok, pos).argmax(-1).cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DECODE_CALLS * 1e3

    plain_engine, plain_out, plain_wall = serve()
    plain_cc = dict(plain_engine.compile_counts)
    del plain_engine
    ledger = Ledger(out_dir / "ledger.jsonl")
    tracer = Tracer(ledger=ledger)
    tel = Telemetry(model_kernel_specs(cfg, ENGINE_SLOTS, ENGINE_MAX_SEQ),
                    CudaEventTimer(hw, seed=SEED), seed=SEED, ledger=ledger)
    # the tracer's cost: one engine, rounds without a tracer, with one and
    # with the phase's (which writes each span to the ledger), the order
    # reversed every other round
    modes = {"plain": None, "tracer": Tracer(), "tracer + ledger": tracer}
    rounds = {m: [] for m in modes}
    try:
        engine, out, wall = serve(trace=tracer, telemetry=tel)
        decode_ms(engine)
        for i in range(TRACER_ROUNDS):
            for mode in list(modes)[::1 if i % 2 == 0 else -1]:
                set_tracer(modes[mode])
                rounds[mode].append(decode_ms(engine))
    finally:
        tel.uninstall()
        tracer.uninstall()
        set_tracer(None)
    median = {m: float(np.median(v)) for m, v in rounds.items()}
    plain_ms, traced_ms = median["plain"], median["tracer"]
    cc = dict(engine.compile_counts)
    n_spans = tracer.write_chrome_trace(str(out_dir / "trace.json"))
    ledger.close()
    chrome = json.loads((out_dir / "trace.json").read_text())
    lines = read_ledger(out_dir / "ledger.jsonl")
    greedy_ids = [i for i in range(N_REQUESTS) if i % 2 == 0]
    same_greedy = all(out[i] == plain_out[i] for i in greedy_ids)
    c = tel.counters
    spans = tracer.summary()
    print(f"  (c) {cfg.name} at full width, {ENGINE_SLOTS} slots, max_seq "
          f"{ENGINE_MAX_SEQ}, {N_REQUESTS} requests (phase 10's), twice: "
          f"plain {plain_wall:.2f} s, with trace= and telemetry= (specs "
          f"{sorted(tel.specs)} over CudaEventTimer) {wall:.2f} s; greedy "
          f"tokens bit-equal: {same_greedy}, all tokens equal: "
          f"{out == plain_out}", flush=True)
    print(f"    decisions by source {dict(c.choices_by_source)} (the "
          f"model's serving steps launch no tuned kernel: its decode "
          f"attention and projections are PyTorch ops); shadow probes "
          f"{c.shadow_probes_total}, {c.probe_device_seconds_total:.6f} "
          f"device-s; probes queued during a capture {tel.deferred_total},"
          f" run after it {tel.deferred_run_total}; refits "
          f"{c.refits_total}; compile_counts {cc} (plain {plain_cc}), "
          f"re-captures {cc['decode_step'] - 1}", flush=True)
    print("    spans: " + "; ".join(
        f"{s['name']} {s['count']} x, {s['total_s'] * 1e3:.3f} ms"
        for s in spans), flush=True)
    cost = traced_ms / plain_ms - 1.0
    print(f"    graphed decode per call, medians of {TRACER_ROUNDS} rounds "
          f"of {DECODE_CALLS} calls each (the step and its greedy tokens to "
          f"the host): {plain_ms:.3f} ms without a tracer, {traced_ms:.3f} "
          f"ms with one (its span and the stream synchronize): "
          f"{cost:+.2%} (the bar {TRACER_COST_BAR:.0%}: printed, not "
          f"gated), {median['tracer + ledger']:.3f} ms with the ledger "
          f"written per span ({median['tracer + ledger'] / plain_ms - 1:+.2%}"
          f"); rounds " + "; ".join(
              f"{m} {[round(v, 3) for v in r]}" for m, r in rounds.items())
          + "; PR 24's graphed decode 6.264 ms", flush=True)
    print(f"    Chrome trace: {n_spans} spans written, "
          f"{len(chrome['traceEvents'])} events read back; ledger: "
          f"{len(lines)} lines read back "
          f"({sorted({e['type'] for e in lines})})", flush=True)
    if not same_greedy:
        raise AssertionError("greedy tokens differ with the tracer and the "
                             "telemetry loop installed")
    if tel.deferred_run_total != tel.deferred_total or tel._deferred:
        raise AssertionError("a probe queued during a capture never ran")
    if cc != plain_cc or n_spans != len(tracer.spans()) or \
            not {"engine.step", "engine.decode", "engine.prefill",
                 "warm_start", "build_step_plan"} <= {s["name"]
                                                      for s in spans}:
        raise AssertionError(f"the observed engine: compile_counts {cc}, "
                             f"spans {[s['name'] for s in spans]}")
    del engine, params, model
    registry.clear()
    part_done("engine")

    launches = launch_counts()              # the path ends here
    print(f"  launches on this path by part: {parts}; in all {launches}",
          flush=True)
    if not (launches["matmul"] and launches["flash_attention"]):
        raise AssertionError(f"a kernel of the phase-26 path never "
                             f"launched: {launches}")
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(26)
    print(json.dumps({"observed": {
        "escalation": {"config": found, "ratio": ratio(found),
                       "flash_tile": tile},
        "refit": {"drift_rel_error_ewma": drift.rel_error_ewma,
                  "executions": r.total_executions,
                  "device_seconds": r.total_device_seconds,
                  "wall_seconds": r.wall_seconds,
                  "served": served, "served_ratio": ratio(served),
                  "driver_choice": chosen,
                  "driver_ratio": ratio(chosen)},
        "capture": {"queued": queued, "ran": ran},
        "engine": {"decode_ms": median, "rounds": rounds,
                   "spans": {s["name"]: s["count"] for s in spans}},
        "launches": launches, "card": card}}, default=str))
    return {"launches": launches}



# Phase 27: the tuning farm and the observatory.  The farm's four tier-1
# builds take the probe settings of the single-process builds of phases 4,
# 8, 12 and 16 (2 repeats, 24 configs per size, each kernel's probe grid);
# every tile table there has at most 9 rows, so 24 configs per size takes
# them all, as phase 8's 12 does.
FARM_WORKERS = 2
FARM_REPEATS, FARM_CONFIGS = 2, 24
# The shapes whose choices the farm's and the single process's drivers are
# timed at: phase 5's gate/up GEMM, phase 9's prefill (bh 32, S 4096) at
# head dim 128, phase 13's prefill, phase 16's up product.
FARM_SHAPES = {
    "matmul_b16": {"m": 4096, "n": 8192, "k": 2048},
    "flash_attn_d128_causal": {"bh": 32, "sq": PREFILL_S, "skv": PREFILL_S},
    "ssd_scan_h64_n128": {"bh": 24, "s": PREFILL_S, "chunkflops": 1},
    "moe_gmm_b16": {"e": GMM_E, "g": GMM_G, "k": GMM_SHAPES[0][1],
                    "n": GMM_SHAPES[0][2]},
}
RETUNE_FRACTION = 0.25          # of phase 25's exhaustive device-seconds
# The farm's probe times against one process's for the same rows: the
# per-row ratio's median and the device-seconds' ratio, each within 10 %.
FARM_TIME_TOL = 0.10


def _farm_probe_data() -> dict:
    from repro_torch.core.kernel_spec import (flash_probe_data,
                                              gmm_probe_data, ssd_probe_data)
    return {"matmul_b16": None, "flash_attn_d128_causal": flash_probe_data(),
            "moe_gmm_b16": gmm_probe_data(),
            "ssd_scan_h64_n128": ssd_probe_data()}


def _farm_results(board) -> list:
    """The result documents a farm's board kept (one per job key)."""
    rdir = os.path.join(board.root, "results")
    return [board.result(n[:-len(".json")]) for n in sorted(os.listdir(rdir))
            if n.endswith(".json")]


def fleet_phase(hw, phase_done, caches: list, card: str,
                mm_pass: tuple) -> dict:
    """Phase 27: the tuning farm (``FleetCoordinator`` with spawned process
    workers taking turns on the card) and the observatory (see the module
    docstring).  ``mm_pass`` is phase 25's exhaustive pass of
    ``matmul_b32`` at N 2048.  Returns the path's launches per kernel
    counter: the main process's and those the workers' results report."""
    import numpy as np

    from repro_torch.core import (CandidateTable, CudaEventTimer,
                                  DriverCache, HopperModel, Klaraptor,
                                  matmul_spec, registry,
                                  warm_start_from_cache)
    from repro_torch.core.card_lock import (LOG_ENV, largest_overlap,
                                            read_intervals)
    from repro_torch.core.collect import collect
    from repro_torch.core.driver import choose_or_default
    from repro_torch.fleet import (FaultPlan, FleetConfig, FleetCoordinator,
                                   RetuneQueue, SpecRef, collected_rows_equal,
                                   drift_key, tier1_spec_refs)
    from repro_torch.kernels import ops
    from repro_torch.obs import Observatory, default_rules, replay_ledgers
    from repro_torch.search import SearchBudget
    from repro_torch.serving.graphs import LAUNCH_COUNTERS, launch_counts
    from repro_torch.telemetry import Telemetry, TelemetryConfig
    from repro_torch.trace import Ledger

    def card_timer():
        return CudaEventTimer(hw, seed=SEED)

    print(f"[27] the tuning farm and the observatory on the card ({card}): "
          f"FleetCoordinator with {FARM_WORKERS} spawned process workers "
          f"taking turns on the card, a kill drill, a ledger-fed retune, "
          f"and an Observatory over the serving side", flush=True)
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="fleet-"))
    caches.append(str(work))
    lock_log = work / "card_lock.log"
    refs = tier1_spec_refs()
    pd = _farm_probe_data()
    ref32 = SpecRef("repro_torch.core", "matmul_spec", (("dtype_bytes", 4),))
    spec32 = ref32.build()
    build_kw = dict(repeats=FARM_REPEATS, max_configs_per_size=FARM_CONFIGS,
                    seed=SEED)

    # -- comparisons first: one process's builds and collect ----------------
    single_cache = DriverCache(str(work / "single"))
    singles, single_wall, single_late = {}, {}, 0
    for name, ref in sorted(refs.items()):
        timer = card_timer()
        t0 = time.perf_counter()
        singles[name] = Klaraptor(timer, cache=single_cache).build_driver(
            ref.build(), probe_data=pd[name], register=False, **build_kw)
        single_wall[name] = time.perf_counter() - t0
        single_late += timer.late
    t0 = time.perf_counter()
    single32 = collect(spec32, card_timer(), hw=hw, **build_kw)
    single32_wall = time.perf_counter() - t0
    print(f"  one process, the same builds: "
          + "; ".join(f"{n} {single_wall[n]:.2f} s, "
                      f"{singles[n].collected.n_probe_executions} probes, "
                      f"{singles[n].probe_device_seconds:.4f} device-s"
                      for n in sorted(singles))
          + f"; in all {sum(single_wall.values()):.2f} s wall; "
          f"{spec32.name}'s collect {single32_wall:.2f} s, "
          f"{single32.n_probe_executions} probes; late enqueue windows "
          f"re-timed {single_late}", flush=True)

    for c in LAUNCH_COUNTERS.values():     # the phase-27 path starts here
        c.reset()
    os.environ[LOG_ENV] = str(lock_log)     # the workers inherit it
    # the workers' launches by part: (a) launches the bf16 matmul and
    # grouped matmul, (b) and (c) the f32 matmul, on one counter each
    worker_launches: dict = {"bf16": {}, "f32": {}}

    def note_workers(board, part: str) -> list:
        docs = _farm_results(board)
        for d in docs:
            for k, n in d.get("launches", {}).items():
                tally = worker_launches[part]
                tally[k] = tally.get(k, 0) + n
        return docs

    # -- (a) the four tier-1 builds, farmed ----------------------------------
    farm_cache = DriverCache(str(work / "farm"))
    t0 = time.perf_counter()
    with FleetCoordinator(work / "spool_a", card_timer(), hw=hw,
                          cache=farm_cache,
                          config=FleetConfig(n_workers=FARM_WORKERS,
                                             backend="process",
                                             job_timeout_s=600)) as fc:
        t_started = time.perf_counter()
        out = fc.tune(refs, probe_data=pd, **build_kw)
        tune_wall = time.perf_counter() - t_started
        farm_wall = time.perf_counter() - t0
        stats_a, counts_a = fc.stats, fc.board.counts()
        dropped_a = fc.board.dropped()
        handles = [w.handle for w in fc.workers]
        docs_a = note_workers(fc.board, "bf16")
    spawned = sorted({type(h).__name__ for h in handles})
    intervals = read_intervals(lock_log)
    overlap = largest_overlap(intervals)
    holders = {r["pid"] for r in intervals}
    device_s = sum(r.collected.probe_device_seconds for r in out.values())
    print(f"  (a) FleetCoordinator.tune(tier1_spec_refs()) on "
          f"{"CudaEventTimer"}, {FARM_WORKERS} {spawned} "
          f"workers: {farm_wall:.2f} s wall with the workers' start "
          f"({tune_wall:.2f} s of tune), one process "
          f"{sum(single_wall.values()):.2f} s; device-seconds "
          f"{device_s:.4f} (one process "
          f"{sum(s.probe_device_seconds for s in singles.values()):.4f}); "
          f"jobs {stats_a.jobs_submitted} by kind {stats_a.by_kind}, board "
          f"{counts_a}, requeues {stats_a.requeues}, speculations "
          f"{stats_a.speculations}, duplicates dropped {len(dropped_a)}",
          flush=True)
    longest_hold = max(r["t1"] - r["t0"] for r in intervals)
    print(f"    the card's lock: {len(intervals)} held intervals from "
          f"{len(holders)} processes (one per row), the longest held "
          f"{longest_hold * 1e3:.2f} ms; largest overlap {overlap:.6f} s; "
          f"longest beat gap {max(d['max_beat_gap_s'] for d in docs_a):.3f}"
          f" s (lease {FleetConfig().lease_s} s)", flush=True)
    if counts_a["results"] != stats_a.jobs_submitted or counts_a["failed"] \
            or len(docs_a) != stats_a.jobs_submitted:
        raise AssertionError(f"a farm job did not complete: {counts_a}")
    if spawned != ["SpawnProcess"] or len(holders) < FARM_WORKERS:
        raise AssertionError(f"workers {spawned}, lock holders {holders}")
    if overlap > 0.0:
        raise AssertionError(f"two timed probes overlapped by {overlap} s")
    picks, row_ratios = {}, {}
    for name in sorted(refs):
        spec = refs[name].build()
        diff = collected_rows_equal(singles[name].collected,
                                    out[name].collected)
        ratio = np.asarray(out[name].collected.metrics["total_time_s"]) / \
            np.asarray(singles[name].collected.metrics["total_time_s"])
        row_ratios[name] = {
            "p50": float(np.median(ratio)),
            "p90": float(np.quantile(ratio, 0.9)),
            "max": float(np.max(ratio)),
            "sum": out[name].collected.probe_device_seconds
            / singles[name].collected.probe_device_seconds}
        print(f"    {name}: farm / one process, row by row: p50 "
              f"{row_ratios[name]['p50']:.3f}, p90 "
              f"{row_ratios[name]['p90']:.3f}, max "
              f"{row_ratios[name]['max']:.3f}; device-seconds "
              f"{row_ratios[name]['sum']:.3f}", flush=True)
        again = Klaraptor(card_timer(), cache=farm_cache).build_driver(
            spec, probe_data=pd[name], register=False, **build_kw)
        D = FARM_SHAPES[name]
        picks[name] = [out[name].driver.choose(D),
                       singles[name].driver.choose(D)]
        print(f"    {name}: rows equal to one process's "
              f"{diff == []} ({len(out[name].collected)} rows, "
              f"{out[name].collected.n_probe_executions} probes); under the "
              f"single-process key {again.from_cache}; at {D} the farm "
              f"driver picks {picks[name][0]}, one process's "
              f"{picks[name][1]} (timed after the path)", flush=True)
        if diff or not again.from_cache or \
                again.driver.source != out[name].driver.source:
            raise AssertionError(f"{name}: the farm's rows {diff} or its "
                                 f"cache key differ from one process's")
        # the farm's drivers land under the single-process key, so their
        # times must be one process's: the median row and the sum within
        # FARM_TIME_TOL
        if not all(abs(row_ratios[name][k] - 1.0) <= FARM_TIME_TOL
                   for k in ("p50", "sum")):
            raise AssertionError(f"{name}: the farm's probe times differ "
                                 f"from one process's: {row_ratios[name]}")

    # -- (b) the kill drill ---------------------------------------------------
    deaths = []
    t0 = time.perf_counter()
    with FleetCoordinator(work / "spool_b", card_timer(), hw=hw,
                          cache=DriverCache(str(work / "farm_b")),
                          config=FleetConfig(n_workers=FARM_WORKERS,
                                             backend="process",
                                             job_timeout_s=600),
                          worker_faults={0: FaultPlan(kill_at_job=1)}) as fc:
        stop = threading.Event()

        def watch():
            while not stop.wait(0.005):
                if fc.stats.worker_deaths > len(deaths):
                    deaths.append(time.time())

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            drilled = fc.tune({spec32.name: ref32}, **build_kw)[spec32.name]
        finally:
            stop.set()
            watcher.join(5.0)
        stats_b = fc.stats
        docs_b = note_workers(fc.board, "f32")
        # the killed lease: the job whose kept result came after a failed
        # attempt; recovered when that result was written
        retried = [d for d in docs_b if d.get("attempts")]
        done_at = [os.path.getmtime(fc.board.result_path(d["key"]))
                   for d in retried]
    drill_wall = time.perf_counter() - t0
    recover_s = (max(done_at) - deaths[0]) if deaths and done_at else None
    diff_b = collected_rows_equal(single32, drilled.collected)
    gap_b = max(d["max_beat_gap_s"] for d in docs_b)
    print(f"  (b) the same tune of {spec32.name} with FaultPlan(kill_at_job"
          f"=1) on w0: {drill_wall:.2f} s wall; deaths "
          f"{stats_b.worker_deaths}, respawns {stats_b.respawns}, requeues "
          f"{stats_b.requeues}; the killed lease "
          f"({[(d['key'][:12], d['worker']) for d in retried]}) done "
          f"{recover_s if recover_s is None else round(recover_s, 3)} s "
          f"after the death was seen; longest beat gap {gap_b:.3f} s; rows "
          f"equal to one process's: {diff_b == []} "
          f"({len(drilled.collected)} rows)", flush=True)
    if stats_b.worker_deaths < 1 or stats_b.respawns < 1 or \
            stats_b.requeues < 1 or recover_s is None:
        raise AssertionError(f"the killed lease was not recovered: "
                             f"{stats_b}")
    if diff_b:
        raise AssertionError(f"the drilled farm's rows differ: {diff_b}")

    # -- (c) drift in a ledger -> RetuneQueue -> farm retune -> warm start --
    feasible, times = mm_pass
    best_s, pass_s = float(np.min(times)), float(np.sum(times))
    D = {"m": SEARCH_N, "n": SEARCH_N, "k": SEARCH_N}
    default = dict(ops.MATMUL_DEFAULT_F32)
    fresh_cache(caches)
    registry.clear()
    off = dataclasses.replace(
        hw, hbm_bw=OFF_PHYSICS_FACTOR * hw.hbm_bw,
        peak_flops_f32=OFF_PHYSICS_FACTOR * hw.peak_flops_f32,
        peak_flops_bf16=OFF_PHYSICS_FACTOR * hw.peak_flops_bf16)
    corrupted = Klaraptor(HopperModel(off, noise=0.04, seed=7), hw=off
                          ).build_driver(spec32, repeats=2,
                                         max_configs_per_size=16, seed=7)
    ledger_path = work / "serving.jsonl"
    ledger = Ledger(ledger_path)
    queue = RetuneQueue(work / "retune.json")
    tel = Telemetry([spec32], card_timer(), seed=3, ledger=ledger,
                    config=TelemetryConfig(probe_every=2,
                                           refit_enabled=False)).install()
    obs = Observatory(telemetry=tel, queue=queue,
                      rules=default_rules()).install()
    decisions = 0
    try:
        for _ in range(24):
            choose_or_default(spec32.name, D, default)
            decisions += 1
            if tel.drift_events:
                break
    finally:
        obs.uninstall()
        tel.uninstall()
    new_keys = queue.ingest(ledger_path)
    alerts = obs.evaluate()
    boosted = {k: r.get("boost") for k, r in queue.state["pending"].items()
               if "boost" in r}
    print(f"  (c) the serving side: {decisions} decisions at N {SEARCH_N} "
          f"on a driver fitted at {OFF_PHYSICS_FACTOR:g}x the card's rates, "
          f"{len(tel.drift_events)} drift (refits left to the farm), ledger "
          f"{ledger.n_written} lines; RetuneQueue.ingest: {new_keys} new "
          f"key(s), pending {[k for k, _ in queue.pending()]}", flush=True)
    print(f"  (d) Observatory(telemetry=, queue=, default_rules()) "
          f"evaluate(): " + ("; ".join(
              f"{a.slo} {a.state} {a.key} value {a.value:.4f} burn "
              f"{a.burn_fast:.1f}/{a.burn_slow:.1f}" for a in alerts)
              or "no alert") + f"; keys a breach boosted in the queue "
          f"{boosted}", flush=True)
    if len(tel.drift_events) != 1 or not queue.pending():
        raise AssertionError("no drift reached the retune queue")
    dkey = drift_key(queue.pending()[0][1])
    gen_before = registry.generation
    src_before = registry.get(spec32.name).source
    version_before = DriverCache().latest_version(spec32.name, hw.name)
    budget = SearchBudget(max_device_seconds=RETUNE_FRACTION * pass_s)
    t0 = time.perf_counter()
    with FleetCoordinator(work / "spool_c", card_timer(), hw=hw,
                          cache=DriverCache(),
                          config=FleetConfig(n_workers=FARM_WORKERS,
                                             backend="process",
                                             job_timeout_s=600)) as fc:
        outcomes = fc.retune(queue, {spec32.name: ref32}, budget=budget,
                             seed=SEED)
        note_workers(fc.board, "f32")
    retune_wall = time.perf_counter() - t0
    version = DriverCache().latest_version(spec32.name, hw.name)
    untouched = registry.generation == gen_before and \
        registry.get(spec32.name).source == src_before
    registry.clear()
    loaded = warm_start_from_cache([spec32], hw=hw)
    read_back = registry.get(spec32.name)
    served = choose_or_default(spec32.name, D, default)
    ratio = best_s / float(times[feasible.index(served)]) \
        if served in feasible else 0.0
    o = outcomes[0] if outcomes else {}
    print(f"    FleetCoordinator.retune({FARM_WORKERS} process workers, "
          f"budget {budget.max_device_seconds:.4f} device-s = "
          f"{RETUNE_FRACTION:.0%} of phase 25's pass): {retune_wall:.2f} s "
          f"wall; {dkey}: succeeded {o.get('succeeded')}, error "
          f"{o.get('error')}, cache_version {o.get('cache_version')}, "
          f"searched {o.get('searched_config')}, override "
          f"{o.get('override')}; queue {queue.summary()}", flush=True)
    print(f"    the versioned cache: tuning_version {version_before} -> "
          f"{version}; the serving registry untouched by the farm: "
          f"{untouched}; a warm start loads {list(loaded)} at "
          f"tuning_version "
          f"{read_back.tuning_version if read_back else None}; served "
          f"{served}, ratio against the pass's best {ratio:.3f}", flush=True)
    if dkey not in queue.state["done"] or not o.get("succeeded"):
        raise AssertionError(f"the drift key was not retuned: {outcomes}")
    if version != version_before + 1 or o.get("cache_version") != version:
        raise AssertionError(f"the cache holds tuning_version {version}")
    if not untouched or read_back is None or \
            read_back.tuning_version != version:
        raise AssertionError("the farm touched the serving registry, or "
                             "the warm start missed the new version")

    # -- (d) the observatory, after the retune ---------------------------
    more = obs.evaluate()
    snap = obs.snapshot()
    prom = obs.prometheus()
    rows = obs.scorecard.as_rows()
    ledger.close()
    replayed = replay_ledgers([ledger_path])
    same = replayed.bus.snapshot_json() == obs.bus.snapshot_json()
    print(f"    after the retune: evaluate() {len(more)} transition(s); "
          f"snapshot {sorted(snap)} (series events "
          f"{snap['series']['n_events']}, firing {snap['slo']['firing']}), "
          f"prometheus {len(prom.splitlines())} lines; scorecard rows "
          f"{[(r['kernel'], r['bucket'], r['probes']) for r in rows]}; "
          f"replay_ledgers of the ledger equals the live bus: {same}",
          flush=True)
    print("    " + obs.scorecard.render_text().replace("\n", "\n    "),
          flush=True)
    if not snap["series"]["n_events"] or not prom.strip() or \
            not any(r["kernel"] == spec32.name for r in rows):
        raise AssertionError("the observatory shows nothing")
    if not same:
        raise AssertionError("the ledger's replay differs from the live bus")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for argv in (["repro_torch.launch.status", "--ledger", str(ledger_path)],
                 ["repro_torch.launch.fleet", "status", "--spool",
                  str(work / "spool_c"), "--state",
                  str(work / "retune.json")]):
        proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                              capture_output=True, text=True, timeout=120)
        head = [ln for ln in proc.stdout.splitlines() if ln.strip()][:3]
        print(f"    python -m {' '.join(argv[:2])} ...: exit "
              f"{proc.returncode}; " + " | ".join(head), flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"{argv[0]} failed:\n{proc.stderr[-2000:]}")
    registry.clear()
    os.environ.pop(LOG_ENV, None)
    all_intervals = read_intervals(lock_log)
    overlap_all = largest_overlap(all_intervals)
    print(f"  the card's lock over (a)-(c): {len(all_intervals)} held "
          f"intervals, largest overlap {overlap_all:.6f} s", flush=True)
    if overlap_all > 0.0:
        raise AssertionError(f"two timed probes overlapped by "
                             f"{overlap_all} s")

    main_launches = launch_counts()          # the path ends here
    # this process launched only (c)'s shadow probes: the f32 matmul
    f32 = dict(worker_launches["f32"])
    for k, n in main_launches.items():
        f32[k] = f32.get(k, 0) + n
    launches = {"bf16": worker_launches["bf16"], "f32": f32}
    print(f"  launches on this path (the workers' kept results, this "
          f"process's shadow probes): (a) {launches['bf16']}, (b) and (c) "
          f"{launches['f32']}", flush=True)
    if not all(launches["bf16"].get(k) for k in (
            "matmul", "flash_attention", "ssd_scan", "moe_gmm")) or \
            not launches["f32"].get("matmul"):
        raise AssertionError(f"a kernel of the phase-27 path never "
                             f"launched: {launches}")
    # after the read: (a)'s choices timed at their shapes (L2-cold
    # medians of the oracle's timings)
    rows_a = []
    for name in sorted(refs):
        spec, D = refs[name].build(), FARM_SHAPES[name]
        pair = CandidateTable.from_rows(spec.program_params, picks[name])
        ms = card_timer().true_time_batch(
            spec.traffic_table(D, pair, hw)) * 1e3
        rows_a.append({"kernel": name, "farm": picks[name][0],
                       "farm_ms": ms[0], "single": picks[name][1],
                       "single_ms": ms[1]})
        print(f"    (a) {name} at {D}: the farm driver's {picks[name][0]} "
              f"{ms[0]:.4f} ms, one process's {picks[name][1]} "
              f"{ms[1]:.4f} ms", flush=True)
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(27)
    print(json.dumps({"fleet": {
        "tune": {"farm_wall_s": farm_wall, "tune_wall_s": tune_wall,
                 "single_wall_s": sum(single_wall.values()),
                 "device_seconds": device_s,
                 "requeues": stats_a.requeues, "dropped": len(dropped_a),
                 "lock_intervals": len(intervals),
                 "longest_hold_s": longest_hold,
                 "largest_overlap_s": overlap,
                 "largest_overlap_all_s": overlap_all, "choices": rows_a,
                 "row_ratios": row_ratios, "single_late": single_late},
        "drill": {"wall_s": drill_wall, "recover_s": recover_s,
                  "max_beat_gap_s": gap_b, "requeues": stats_b.requeues},
        "retune": {"wall_s": retune_wall, "version": version,
                   "served": served, "ratio": ratio},
        "observatory": {"alerts": [a.to_event() for a in alerts + more],
                        "boosted": boosted, "replay_equal": same},
        "launches": launches, "card": card}}, default=str))
    return {"launches": launches}


def _bwd_bound_ms(bh: int, hkv_rows: int, s: int, d: int,
                  window: int | None = None,
                  elem: int = 2) -> tuple[float, str]:
    """Least time of one causal flash-attention backward on the card: q,
    k, v, the output, its gradient and the f32 lse read once, dq, dk and dv
    written once (``elem`` bytes each), and 2.5 times the forward's FLOPs
    (five products of 2 d FLOPs per visible pair against two; the window's
    pairs only) at the tensor-core peak of bf16 inputs (the FP32 rate for
    f32)."""
    pairs = _visible_pairs(s, s, True, window)
    t_ops = 2.5 * 4.0 * d * bh * pairs / (PEAK_BF16 if elem == 2
                                          else PEAK_F32)
    reads = (3 * bh * s + 2 * hkv_rows * s) * d     # q, o, dO; k, v
    writes = (bh * s + 2 * hkv_rows * s) * d        # dq; dk, dv
    t_bytes = ((reads + writes) * elem + bh * s * 4) / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _leaf_rel(a: dict, b: dict) -> dict:
    """max |a - b| / max |b| per leaf path of two gradient trees, each leaf
    read in flat chunks of 2^26 elements (the f32 copies of grok-1's 1.6
    G-element expert gradients would take 19 GB at once)."""
    import torch

    from repro_torch.tree import tree_paths
    out = {}
    for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        pairs = list(zip(x.reshape(-1).split(1 << 26),
                         y.reshape(-1).split(1 << 26)))
        ref = float(torch.stack([q.float().abs().max() for _, q in pairs])
                    .max())
        diff = float(torch.stack([(p.float() - q.float()).abs().max()
                                  for p, q in pairs]).max())
        out[path] = diff / max(ref, 1e-30)
    return out


def _long_context_step(dev, flash, arch: str = "llama3.2-1b",
                       seq: int = PREFILL_S, part: str = "(d)",
                       windowed: bool = False) -> dict:
    """One train step of ``arch`` at full width, B 1 x S ``seq``
    (``loss_and_grads`` and ``adamw_update`` through ``make_train_step``;
    weights at std 1 / sqrt(fan-in)): a warm-up step, a timed one with its
    peak memory, and a profiled one for the flash backward's share of
    device-busy.  Phase 28 (d) is llama3.2-1b at S 4096, phase 30 (c)
    gemma2-2b at S 8192 with ``windowed``: the timed step's backward
    launches made with a window are read and gated.  Gated: finite losses,
    that the wgmma backward ran at S ``seq``, and with ``windowed`` that a
    windowed backward ran; a step that does not fit in memory fails the
    phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch)
    model = Model(cfg)
    print(f"  {part} one long-context step: {cfg.name} at full width, B 1 x "
          f"S {seq}, loss_and_grads + adamw_update (gates: finite losses, "
          f"the wgmma backward ran"
          + (", a windowed backward ran)" if windowed else ")"), flush=True)
    try:
        params = model.init(SEED + 2)
        _fan_in_scaled(model, params)
        opt_cfg = AdamWConfig(lr=1e-4, weight_decay=0.01)
        opt_state = adamw_init(opt_cfg, params)
        step = make_train_step(model, opt_cfg)
        batch = {"tokens": torch.as_tensor(SyntheticStream(SyntheticConfig(
            cfg.vocab_size, seq, 1, seed=SEED + 2)).next_batch()[
                "tokens"], device=dev)}
        params, opt_state, m0 = step(params, opt_state, batch)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.BACKWARD_LAUNCHES.reset()
        t0 = time.perf_counter()
        params, opt_state, m1 = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        ran = flash.BACKWARD_LAUNCHES.tiles.get(
            (cfg.n_heads, seq, seq, cfg.head_dim, True), {})
        launches = flash.BACKWARD_LAUNCHES.count
        n_windowed = flash.BACKWARD_LAUNCHES.windowed.count if windowed \
            else None
        losses = [float(m0["loss"]), float(m1["loss"])]
        out = {}
        prof = _device_profile(
            lambda: out.update(m=step(params, opt_state, batch)[2]),
            f"one {cfg.name} train step at B 1 x S {seq}",
            groups=TRAIN_PROFILE_GROUPS, ranges=("adamw_update",))
        losses.append(float(out["m"]["loss"]))
    finally:
        params = opt_state = None
        gc.collect()
        torch.cuda.empty_cache()
    share = prof["flash_bwd"] / prof["busy_ms"] if prof else float("nan")
    print(f"  {part} {step_ms:.2f} ms a step (the second), peak memory "
          f"{peak:.2f} GiB, losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"flash backward {launches} launches a step"
          + (f" ({n_windowed} windowed)" if windowed else "")
          + f", body {ran}, {share:.1%} of device-busy", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a long-context loss is not finite: {losses}")
    if not launches or ran.get("body") != "wgmma":
        raise AssertionError(f"the long-context step ran the flash backward "
                             f"{launches} times, body {ran}")
    if windowed and not n_windowed:
        raise AssertionError(f"the long-context step ran no windowed flash "
                             f"backward ({launches} launches)")
    return {"arch": cfg.name, "seq": seq, "step_ms": step_ms,
            "peak_gib": peak, "losses": losses,
            "flash_bwd_launches": launches,
            "flash_bwd_windowed": n_windowed, "flash_bwd_share": share,
            "profile": prof}


def train_phase(dev, hw, gen, check, time_ms, phase_done,
                card: str) -> dict:
    """Phase 28: training on the card.  (a) the flash-attention backward
    kernel alone at llama3.2-1b's training and prefill shapes and
    internlm2-1.8b's d 128 attention; (b) ``TrainLoop`` on llama3.2-1b at
    full width; (c) a crash and resume at two layers, bit-exact, and the
    guards of the ops with no backward (the matmul, the layernorm); (d)
    one long-context step
    (``_long_context_step``).  Returns the backward kernel's row of the
    ``kernels`` line and the flash forward's launches on the training
    path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, tree_paths

    t_phase = time.perf_counter()
    # -- (a) the backward kernel alone --------------------------------------
    print("[28] training on the card.  (a) the flash-attention backward "
          "kernel (csrc/flash_attention_bwd.cu: bf16 on the wgmma + TMA-ring "
          "body -- prep, dK / dV, dQ; f32 on the SIMT body; no atomics) "
          "against flash_attention_backward_plain, causal, at llama3.2-1b's "
          "training and prefill shapes (GQA 32 / 8, d 64) and internlm2-"
          "1.8b's (16 / 8, d 128) (gates: each of dq, dk, dv within 2e-2 x "
          "max |plain|; the wgmma body ran; two calls bit-equal; no spilled "
          "bytes in the wgmma kernels; the profiler sees each of its three "
          "kernels)", flush=True)
    for hd in flash.SIMT_BACKWARD_HEAD_DIMS:      # d 256: phase 30
        for dt, body in ((torch.float32, "f32 SIMT"),
                         (torch.bfloat16, "bf16 wgmma")):
            attrs = {k: flash.backward_attributes(dt, hd, k)
                     for k in flash.BACKWARD_KERNELS}
            print(f"  registers / spilled bytes, {body} body, d {hd}: "
                  + ", ".join(f"{k} {a['num_regs']} / {a['local_bytes']}"
                              for k, a in attrs.items()), flush=True)
            if dt == torch.bfloat16 and any(a["local_bytes"]
                                            for a in attrs.values()):
                raise AssertionError(f"the wgmma backward spills at d {hd}: "
                                     f"{attrs}")
    shapes = []
    worst = 0.0
    for name, B, S, hq, hkv, d in (
            ("train", TRAIN_B, TRAIN_S, 32, 8, 64),
            ("prefill", 1, PREFILL_S, 32, 8, 64),
            ("internlm2_d128", 1, PREFILL_S, 16, 8, 128)):
        q = torch.randn(B * hq, S, d, generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn(B * hkv, S, d, generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=True)
        tiles = dict(bq=64, bkv=128)
        out0 = flash.flash_attention_kernel(q, k, v, **tiles, **kw)
        out, lse = flash.flash_attention_kernel(q, k, v, **tiles, **kw,
                                                return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out, out0):
            raise AssertionError(f"{name}: the forward's output changed "
                                 f"when it also wrote lse")
        dout = torch.randn(out.shape, generator=gen, device=dev
                           ).to(torch.bfloat16)
        got = flash.flash_attention_backward_kernel(q, k, v, out, dout, lse,
                                                    **kw)
        again = flash.flash_attention_backward_kernel(q, k, v, out, dout,
                                                      lse, **kw)
        ran = flash.BACKWARD_LAUNCHES.tiles[(B * hq, S, S, d, True)]
        ref = flash.flash_attention_backward_plain(q, k, v, out, dout, lse,
                                                   **kw)
        torch.cuda.synchronize()
        if ran["body"] != "wgmma":
            raise AssertionError(f"{name}: bf16 ran the {ran['body']} body")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward calls differ")
        errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: non-finite {gname}")
            scale = float(r.float().abs().max())
            errs[gname] = float((g.float() - r.float()).abs().max()) / scale
            if errs[gname] > 2e-2:
                raise AssertionError(f"{name}: {gname} differs from the "
                                     f"plain backward by {errs[gname]:.3e} "
                                     f"of max |plain|")
        worst = max([worst] + [float((g.float() - r.float()).abs().max())
                               for g, r in zip(got, ref)])
        del got, again, ref
        bound, bound_by = _bwd_bound_ms(B * hq, B * hkv, S, d)

        def bwd():
            return flash.flash_attention_backward_kernel(q, k, v, out, dout,
                                                         lse, **kw)

        qs = q.reshape(B, hq, S, d).detach().requires_grad_()
        ks, vs = (t.reshape(B, hkv, S, d).detach().requires_grad_()
                  for t in (k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        do4 = dout.reshape(B, hq, S, d)

        def sdpa_bwd():
            return torch.autograd.grad(o, (qs, ks, vs), do4,
                                       retain_graph=True)

        ms = time_ms(bwd)
        sdpa_event_ms = time_ms(sdpa_bwd)
        plain_ms = time_ms(lambda: flash.flash_attention_backward_plain(
            q, k, v, out, dout, lse, **kw), max_iters=1)
        fwd_ms = time_ms(lambda: flash.flash_attention_kernel(
            q, k, v, **tiles, **kw))
        fwd_lse_ms = time_ms(lambda: flash.flash_attention_kernel(
            q, k, v, **tiles, **kw, return_lse=True))
        def both():
            # late in this script the profiler loses the kernels near either
            # end of a short window (PERF.md §7): host waits on both sides
            # keep the calls clear of them
            time.sleep(BWD_PROFILE_PAD_S)
            for fn in (bwd, sdpa_bwd):
                for _ in range(BWD_PROFILE_CALLS):
                    fn()
            torch.cuda.synchronize()
            time.sleep(BWD_PROFILE_PAD_S)

        # SDPA's backward is host-bound at the training shape, so its events
        # time the host: its device time is the sum of its kernels' in a trace
        prof = _device_profile(
            both, f"{BWD_PROFILE_CALLS} calls each of the backward and of "
            f"SDPA's backward (other) at {name}", groups=BWD_SPLIT_GROUPS,
            cpu=False)
        if not prof or not all(prof[g] > 0 for g, _ in BWD_SPLIT_GROUPS) \
                or prof["other"] <= 0:
            raise AssertionError(f"{name}: the profile shows not all of the "
                                 f"backward's kernels and SDPA's: {prof}")
        split = {g: prof[g] / BWD_PROFILE_CALLS for g, _ in BWD_SPLIT_GROUPS}
        sdpa_ms = prof["other"] / BWD_PROFILE_CALLS
        device_ms = sum(split.values())
        row = {"shape": name, "bh": B * hq, "s": S, "d": d, "gqa": hq // hkv,
               "rel_err": errs, "ms": ms, "device_ms": device_ms,
               "split_ms": split, "plain_ms": plain_ms,
               "library_ms": sdpa_ms, "library_event_ms": sdpa_event_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "pct_of_bound": 100.0 * bound / ms, "fwd_ms": fwd_ms,
               "fwd_lse_ms": fwd_lse_ms}
        shapes.append(row)
        print(f"  {name} (bh {B * hq}, S {S}, d {d}, GQA {hq // hkv}): rel "
              f"err dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
              f"{errs['dv']:.2e} ok, wgmma body, two calls bit-equal; kernel "
              f"{ms:.4f} ms ({row['pct_of_bound']:.1f} % of bound), its "
              f"kernels' device time {device_ms:.4f} ms (" + ", ".join(
                  f"{g} {t:.4f}" for g, t in split.items()) + f") | plain "
              f"{plain_ms:.3f} ms | SDPA backward {sdpa_ms:.4f} ms of device "
              f"time ({ms / sdpa_ms:.2f}x; {sdpa_event_ms:.4f} ms by events) "
              f"| bound {bound:.4f} ms ({bound_by}); forward {fwd_ms:.4f} ms, "
              f"with lse {fwd_lse_ms:.4f} ms, output bit-equal", flush=True)
        del q, k, v, out, out0, lse, dout, qs, ks, vs, o, do4
        torch.cuda.empty_cache()

    # -- (b) TrainLoop on llama3.2-1b at full width --------------------------
    cfg = get_config("llama3.2-1b")
    model = Model(cfg)
    params = model.init(SEED)
    _fan_in_scaled(model, params)
    preset = ShapePreset("chip", "train", TRAIN_S, TRAIN_B)
    batch = {"tokens": torch.as_tensor(SyntheticStream(SyntheticConfig(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)).next_batch()["tokens"],
        device=dev)}
    print(f"  (b) TrainLoop, {cfg.name} at full width ({cfg.n_layers} layers,"
          f" d {cfg.d_model}, {model.param_count() / 1e9:.3f} B parameters, "
          f"bf16, remat {cfg.remat!r}, weights at std 1 / sqrt(fan-in)), "
          f"B {TRAIN_B} x S {TRAIN_S} from SyntheticStream, "
          f"{TRAIN_STEPS} steps; first the step-1 gradient against the same "
          f"step with autograd through flash_attention_plain (gate: "
          f"max |d| <= 5e-2 x max |g| per leaf, loss within 1e-2)",
          flush=True)
    m_k, g_k = loss_and_grads(model, params, batch)
    m_p, g_p = loss_and_grads(model, params, batch,
                              attn_op=flash.flash_attention_plain)
    torch.cuda.synchronize()
    for path, g in tree_paths(g_k):
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            raise AssertionError(f"step 1: the gradient of {path} is not "
                                 f"finite and non-zero")
    rel = _leaf_rel(g_k, g_p)
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"  step 1: loss {loss_k:.6f} (plain attention {loss_p:.6f}, "
          f"|d| {abs(loss_k - loss_p):.3e}); {len(rel)} leaves all finite "
          f"and non-zero; largest per-leaf max |d| / max |g|: "
          + ", ".join(f"{p} {r:.3e}" for p, r in top), flush=True)
    if max(rel.values()) > 5e-2 or abs(loss_k - loss_p) > 1e-2 * abs(loss_p):
        raise AssertionError(f"step 1 disagrees with the plain-attention "
                             f"step: {top}, loss {loss_k} vs {loss_p}")
    del g_p, m_p
    torch.cuda.empty_cache()

    ckpt_root = tempfile.mkdtemp(prefix="klaraptor-train-")
    try:
        loop = TrainLoop(cfg, preset, ckpt_dir=os.path.join(ckpt_root, "b"),
                         ckpt_every=TRAIN_STEPS // 2 + 1, keep=1, seed=SEED,
                         params=params)
        loop.init_state()
        del params
        counters = (flash.LAUNCHES, flash.BACKWARD_LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        hist = loop.run(TRAIN_STEPS, log_every=1)      # the main path
        fwd_launches, bwd_launches = (c.count for c in counters)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        for m in hist:
            print(f"    step {m['step']:2d}: loss {m['loss']:.4f} grad_norm "
                  f"{m['grad_norm']:.4f} lr {m['lr']:.2e} "
                  f"{m['step_time_s'] * 1e3:.2f} ms", flush=True)
        if not all(np.isfinite(m["loss"]) for m in hist):
            raise AssertionError("a training loss is not finite")
        if not fwd_launches or not bwd_launches:
            raise AssertionError(f"the training path launched flash forward "
                                 f"{fwd_launches} and backward "
                                 f"{bwd_launches} times")
        bodies = {t["body"] for t in flash.BACKWARD_LAUNCHES.tiles.values()}
        if bodies != {"wgmma"}:
            raise AssertionError(f"the training path's flash backward ran "
                                 f"the {bodies} bodies, not wgmma alone")
        step_ms = float(np.median([m["step_time_s"] for m in hist[2:]])) \
            * 1e3
        saves = loop.manager.timings
        print(f"  {TRAIN_STEPS} steps in {wall:.2f} s of wall (both saves "
              f"included); ms per step (median of steps 3-{TRAIN_STEPS}) "
              f"{step_ms:.2f}, {TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} "
              f"tokens/s; peak memory {peak:.2f} GiB; flash launches per "
              f"step: forward {fwd_launches / TRAIN_STEPS:g} (remat "
              f"{cfg.remat!r}: each layer's forward runs twice), backward "
              f"{bwd_launches / TRAIN_STEPS:g}; saves (keep 1): "
              + ", ".join(f"step {t['step']} host copy {t['copy_s']:.2f} s, "
                          f"write {t.get('write_s', float('nan')):.2f} s"
                          for t in saves), flush=True)
        tree = {"params": loop.params, "mu": loop.opt_state["mu"],
                "nu": loop.opt_state["nu"]}
        ckpt_gb = sum(t.numel() * t.element_size()
                      for t in tree_leaves(tree)) / 2**30
        del tree
        # after the read: one step profiled; its optimizer is the kernels
        # under the step's adamw_update range
        batch = loop.next_batch()
        prof = _device_profile(
            lambda: loop.step_fn(loop.params, loop.opt_state, batch),
            "one train step (adamw_update = the optimizer's kernels, other "
            "= elementwise and the rest)", groups=TRAIN_PROFILE_GROUPS,
            ranges=("adamw_update",))
        if not prof or prof["adamw_update"] <= 0.0:
            raise AssertionError(f"the profile of a train step holds no "
                                 f"optimizer kernel: {prof}")
        del loop
        gc.collect()
        torch.cuda.empty_cache()

        # -- (c) crash and resume at 2 layers, bit-exact; the guards ------
        cfg2 = cfg.replace(n_layers=2)
        model2 = Model(cfg2)
        params2 = model2.init(SEED + 1)
        _fan_in_scaled(model2, params2)
        crash = dict(ckpt_every=4, keep=1, seed=SEED, params=params2)
        t0 = time.perf_counter()
        a = TrainLoop(cfg2, preset, seed=SEED, params=params2)
        a.init_state()
        a.run(6, log_every=6)
        b = TrainLoop(cfg2, preset, ckpt_dir=os.path.join(ckpt_root, "c"),
                      **crash)
        b.init_state()
        try:
            b.run(6, fail_at=5)
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        b.manager.wait()
        b2 = TrainLoop(cfg2, preset, ckpt_dir=os.path.join(ckpt_root, "c"),
                       **crash)
        resumed = b2.restore_or_init()
        b2.run(6, log_every=6)
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves({"params": a.params, "opt": a.opt_state}),
            tree_leaves({"params": b2.params, "opt": b2.opt_state})))
        print(f"  (c) crash and resume, {cfg2.n_layers} layers at full "
              f"width: a run of 6 steps against one that fails at step 5 "
              f"and resumes from step {resumed}: parameters and moments "
              f"bit-equal {same} ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        if resumed != 4 or not same:
            raise AssertionError(f"resumed from {resumed}; bit-equal {same}")
        del a, b, b2, params2
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    x = torch.randn(2, 64, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    for name, call in (
            ("matmul", lambda: ops.matmul(x, torch.randn(
                64, 64, device=dev, dtype=torch.bfloat16))),
            ("layernorm", lambda: ops.layernorm(
                x[0], x[0], torch.ones(64, device=dev, dtype=torch.bfloat16),
                torch.zeros(64, device=dev, dtype=torch.bfloat16)))):
        try:
            call()
        except ops.MissingBackwardError as e:
            print(f"  ops.{name} on a card input that requires grad raises: "
                  f"{e}", flush=True)
        else:
            raise AssertionError(f"ops.{name} ran on a card input that "
                                 f"requires grad: its gradient would be "
                                 f"cut silently")
    long_step = _long_context_step(dev, flash)
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(28)
    train = {"step_ms": step_ms, "tokens_per_s": TRAIN_B * TRAIN_S
             / step_ms * 1e3, "peak_gib": peak, "ckpt_gib": ckpt_gb,
             "losses": [m["loss"] for m in hist],
             "grad_norms": [m["grad_norm"] for m in hist],
             "step1_max_leaf_rel": max(rel.values()),
             "saves": saves, "profile": prof,
             "flash_fwd_per_step": fwd_launches / TRAIN_STEPS,
             "flash_bwd_per_step": bwd_launches / TRAIN_STEPS,
             "long_context_step": long_step}
    print(json.dumps({"train": train, "card": card}, default=str))
    total = {k: sum(r[k] for r in shapes)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    row = {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:70",
        "replaces_note": "no TPU kernel: the JAX package differentiates "
                         "flash_attention_ref with XLA",
        "launches": bwd_launches,
        "max_abs_err": worst,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": "operations"
        if all(r["bound_by"] == "operations" for r in shapes) else "bytes",
        "library_ms": total["library_ms"],
        "shapes": shapes,
    }
    return {"row": row, "flash_launches": fwd_launches}


def _ssd_bwd_bound_ms(bh: int, groups: int, s: int, dh: int, n: int,
                      chunk: int, elem: int) -> tuple[float, str]:
    """Least time of one SSD backward on the card: x, dy, f32 dt, A and the
    f32 entering states (one (n, dh) tile per chunk) read once, B and C
    once per group, dx, dB, dC, f32 ddt and dA written once; and the FLOPs
    of the chunked backward at ``chunk`` (per chunk of l rows and its p = l
    (l + 1) / 2 causal pairs: C B^T, dy x^T and the products for dx, dB and
    dC, 2 p (3 n + 2 dh); the five state products, 10 l n dh) at the
    tensor-core peak of bf16 inputs (the FP32 rate for f32)."""
    ops = 0.0
    chunks = 0
    for c0 in range(0, s, chunk):
        rows = min(chunk, s - c0)
        pairs = rows * (rows + 1) / 2
        ops += 2.0 * pairs * (3 * n + 2 * dh) + 10.0 * rows * n * dh
        chunks += 1
    t_ops = bh * ops / (PEAK_BF16 if elem == 2 else PEAK_F32)
    t_bytes = (3 * bh * s * dh * elem + 4 * groups * s * n * elem
               + bh * (2 * s + 2) * 4 + bh * chunks * n * dh * 4) / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _gmm_bwd_bound_ms(e: int, g: int, k: int, n: int,
                      elem: int) -> tuple[float, str]:
    """Least time of one grouped-matmul backward on the card: x, w and dy
    read once, dx and dw written once, and the two products' 4 e g k n
    FLOPs at the tensor-core peak of bf16 inputs (the FP32 rate for
    f32)."""
    t_ops = 4.0 * e * g * k * n / (PEAK_BF16 if elem == 2 else PEAK_F32)
    t_bytes = (2 * e * g * k + 2 * e * k * n + e * g * n) * elem / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _train_more_counters():
    """The launch counters of the kernels phase 29 trains through, by the
    names of the ``kernels`` line's rows."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": flash.LAUNCHES,
            "flash_attention_backward": flash.BACKWARD_LAUNCHES,
            "ssd_scan": ssd.LAUNCHES,
            "ssd_scan_backward": ssd.BACKWARD_LAUNCHES,
            "moe_gmm": gmm.LAUNCHES,
            "moe_gmm_backward": gmm.BACKWARD_LAUNCHES}


def _ssd_backward_alone(dev, gen, time_ms) -> list:
    """Phase 29 (a), the SSD scan: the backward kernel against its plain
    version at mamba2-130m's training and prefill shapes, at the chunk
    ``ops.ssd_scan`` takes with grad on; gated and timed (see
    ``train_more_phase``), each bf16 call also timed on the SIMT body at
    the same shape (``body="simt"``; its gradients gated the same way)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    dh, n = 64, 128
    rows = []
    for name, bh, h, s in SSD_BWD_SHAPES:
        for dtype in ((torch.bfloat16, torch.float32) if name == "train"
                      else (torch.bfloat16,)):
            x = (torch.randn(bh, s, dh, generator=gen, device=dev) * 0.5
                 ).to(dtype)
            dt = 0.01 + 0.5 * torch.rand(bh, s, generator=gen, device=dev)
            B, C = ((torch.randn(bh // h, s, n, generator=gen, device=dev)
                     * 0.3).to(dtype) for _ in range(2))
            A = -0.5 - torch.rand(bh, generator=gen, device=dev)
            ins = (x, dt, B, C, A)
            dy = torch.randn(bh, s, dh, generator=gen, device=dev).to(dtype)
            # the chunk the op trains at: one call through its Function
            leaves = [t.detach().requires_grad_() for t in ins]
            torch.autograd.grad(ops.ssd_scan(*leaves), leaves, dy)
            tiles = ssd.BACKWARD_LAUNCHES.tiles[(bh, s, dh, n)]
            chunk, body = tiles["chunk"], tiles["body"]
            attrs = ssd.backward_tile_attributes(dh, n, chunk) \
                if body == "sm90" else ssd.backward_attributes(dtype)
            y0 = ssd.ssd_scan_kernel(*ins, chunk=chunk)
            y1, states = ssd.ssd_scan_kernel(*ins, chunk=chunk,
                                             return_states=True)
            got = ssd.ssd_scan_backward_kernel(*ins, states, dy, chunk=chunk)
            again = ssd.ssd_scan_backward_kernel(*ins, states, dy,
                                                 chunk=chunk)
            _, pstates = ssd.ssd_scan_plain(*ins, chunk=chunk,
                                            return_states=True)
            ref = ssd.ssd_scan_backward_plain(*ins, pstates, dy, chunk)
            torch.cuda.synchronize()
            what = f"SSD backward {name} {str(dtype)[6:]} (bh {bh}, S {s})"
            if not torch.equal(y0, y1):
                raise AssertionError(f"{what}: the forward's output changed "
                                     f"when it also wrote its states")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what}: two backward calls differ")
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
            errs = {}
            for gname, g, r in zip(("dx", "ddt", "dB", "dC", "dA"), got, ref):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{what}: non-finite {gname}")
                errs[gname] = float((g.float() - r.float()).abs().max()) \
                    / float(r.float().abs().max())
                if errs[gname] > tol:
                    raise AssertionError(f"{what}: {gname} differs from the "
                                         f"plain backward by "
                                         f"{errs[gname]:.3e} of max |plain|")
            worst = max(float((g.float() - r.float()).abs().max())
                        for g, r in zip(got, ref))
            simt_ms = None
            if body != "simt":
                simt = ssd.ssd_scan_backward_kernel(*ins, states, dy,
                                                    chunk=chunk, body="simt")
                for gname, g, r in zip(("dx", "ddt", "dB", "dC", "dA"), simt,
                                       ref):
                    err = float((g.float() - r.float()).abs().max()) \
                        / float(r.float().abs().max())
                    if not bool(torch.isfinite(g).all()) or err > tol:
                        raise AssertionError(f"{what}: the SIMT body's "
                                             f"{gname} differs from the plain "
                                             f"backward by {err:.3e}")
                del simt
                simt_ms = time_ms(lambda: ssd.ssd_scan_backward_kernel(
                    *ins, states, dy, chunk=chunk, body="simt"))
            del got, again, ref, pstates
            ms = time_ms(lambda: ssd.ssd_scan_backward_kernel(
                *ins, states, dy, chunk=chunk))
            plain_ms = time_ms(lambda: ssd.ssd_scan_backward_plain(
                *ins, states, dy, chunk), max_iters=1)
            fwd_ms = time_ms(lambda: ssd.ssd_scan_kernel(*ins, chunk=chunk))
            fwd_states_ms = time_ms(lambda: ssd.ssd_scan_kernel(
                *ins, chunk=chunk, return_states=True))
            bound, bound_by = _ssd_bwd_bound_ms(bh, bh // h, s, dh, n, chunk,
                                                x.element_size())
            row = {"shape": name, "dtype": str(dtype)[6:], "bh": bh, "s": s,
                   "chunk": chunk, "body": body,
                   "num_regs": attrs["num_regs"],
                   "local_bytes": attrs["local_bytes"],
                   "rel_err": errs, "max_abs_err": worst,
                   "ms": ms, "simt_ms": simt_ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "pct_of_bound": 100.0 * bound / ms,
                   "fwd_ms": fwd_ms, "fwd_states_ms": fwd_states_ms,
                   "states_mb": states.numel() * 4 / 1e6}
            rows.append(row)
            simt = "" if simt_ms is None else \
                f" | SIMT body {simt_ms:.4f} ms ({simt_ms / ms:.2f}x)"
            print(f"  {what}, chunk {chunk}, {body} body ({attrs['num_regs']} "
                  f"registers, {attrs['local_bytes']} spilled bytes): rel "
                  f"err " + " ".join(
                f"{k} {v:.2e}" for k, v in errs.items()) + f" ok, two calls "
                f"bit-equal, forward bit-equal with its states "
                f"({row['states_mb']:.1f} MB); kernel {ms:.4f} ms "
                f"({row['pct_of_bound']:.1f} % of bound){simt} | plain "
                f"{plain_ms:.3f} ms | bound {bound:.4f} ms ({bound_by}); "
                f"forward {fwd_ms:.4f} ms, with states {fwd_states_ms:.4f} "
                f"ms", flush=True)
            del x, dt, B, C, A, ins, dy, states, leaves
            torch.cuda.empty_cache()
    return rows


def _gmm_backward_alone(dev, gen, time_ms) -> list:
    """Phase 29 (a), the grouped matmul: the backward kernel against its
    plain version at qwen3-moe's and grok-1's training shapes (one layer's
    gate / up and down products at B 8 x S 256; qwen3-moe's gate / up in f32
    too), at the launch parameters ``ops.moe_gmm`` resolves with grad on,
    and that call's forward against the plain product; both
    gated (grok-1 on ``GMM_BWD_GATED_EXPERTS`` of the same call's outputs)
    and timed whole and, in bf16, dX and dW each alone, beside ``torch.bmm``
    of the same products and the bounds (see ``train_more_phase``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    rows = []
    for arch, dt in GMM_BWD_SHAPES:
        cfg = get_config(arch)
        G, _, C = L.moe_groups(cfg, TRAIN_B * TRAIN_S)
        e, g = cfg.n_experts, G * C
        d, ff = cfg.d_model, cfg.moe_d_ff
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        for name, k, n in (("gate_up", d, ff), ("down", ff, d))[
                :1 if dt == "f32" else 2]:
            row = _gmm_backward_shape(dev, gen, time_ms, arch, name, e, g, k,
                                      n, dtype)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _gmm_backward_shape(dev, gen, time_ms, arch, name, e, g, k, n,
                        dtype) -> dict:
    """One row of ``_gmm_backward_alone``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.benchmarks.gmm_backward import bound_ms
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops

    x = torch.randn(e, g, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(e, k, n, generator=gen, device=dev) * k ** -0.5
         ).to(dtype)
    dy = torch.randn(e, g, n, generator=gen, device=dev).to(dtype)
    # the launch parameters the op trains at: one call through its Function,
    # whose forward is held against the plain product below
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    out = ops.moe_gmm(xl, wl)
    torch.autograd.grad(out, (xl, wl), dy)
    out = out.detach()
    del xl, wl
    gp = ops.gemm_dims(ops.gmm_kernel_name(dtype),
                       {"e": e, "g": g, "k": k, "n": n})["g"]
    tiles = gmm.BACKWARD_LAUNCHES.tiles[(e, gp, k, n)]
    keys = gmm.BACKWARD_KEYS if dtype == torch.bfloat16 \
        else ("bg", "bn", "bk")
    kw = {p + "_tiles": dict(zip(keys, tiles[p])) for p in ("dx", "dw")}
    xp, dyp = (F.pad(t, (0, 0, 0, gp - g)) for t in (x, dy))
    del x, dy

    def bwd(products=("dx", "dw")):
        return gmm.moe_gmm_backward_kernel(xp, w, dyp, products=products,
                                           **kw)

    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    what = (f"grouped-matmul backward {arch} {name} {str(dtype)[6:]} (e {e}, "
            f"g {g} -> {gp}, {k} -> {n})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two backward calls differ")
    del again
    sel = list(range(e) if arch.startswith("qwen")
               else GMM_BWD_GATED_EXPERTS)
    t0 = time.perf_counter()
    ref = gmm.moe_gmm_backward_plain(xp[sel], w[sel], dyp[sel])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    fwd_ref = gmm.moe_gmm_plain(xp[sel, :g], w[sel])
    fwd = out[sel]
    fwd_err = float((fwd.float() - fwd_ref.float()).abs().max()) / float(
        fwd_ref.float().abs().max())
    if not bool(torch.isfinite(fwd).all()) or fwd_err > tol:
        raise AssertionError(f"{what}: the forward differs from the plain "
                             f"product by {fwd_err:.3e} of max |plain| "
                             f"(experts {sel})")
    del out, fwd, fwd_ref
    errs, worst = {}, 0.0
    for gname, a, r in zip(("dx", "dw"), got, ref):
        a = a[sel]
        diff = float((a.float() - r.float()).abs().max())
        errs[gname] = diff / float(r.float().abs().max())
        worst = max(worst, diff)
        if not bool(torch.isfinite(a).all()) or errs[gname] > tol:
            raise AssertionError(f"{what}: {gname} differs from the plain "
                                 f"backward by {errs[gname]:.3e} of max "
                                 f"|plain| (experts {sel})")
    del got, ref
    wt, xt = w.transpose(1, 2), xp.transpose(1, 2)
    ms = time_ms(bwd)
    library_ms = time_ms(lambda: (torch.bmm(dyp, wt), torch.bmm(xt, dyp)))
    row = {"arch": arch, "shape": name, "dtype": str(dtype)[6:], "e": e,
           "g": gp, "k": k, "n": n, "dx_tiles": tiles["dx"],
           "dw_tiles": tiles["dw"], "rel_err": errs, "gated_experts": sel,
           "fwd_rel_err": fwd_err,
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "plain_experts": len(sel), "library_ms": library_ms,
           "in_totals": arch.startswith("qwen")}
    if dtype == torch.bfloat16:
        for p in ("dx", "dw"):
            row[f"{p}_ms"] = time_ms(lambda p=p: bwd((p,)))
            row[f"bound_{p}_ms"] = bound_ms(e, gp, k, n, p)
        row["library_dx_ms"] = time_ms(lambda: torch.bmm(dyp, wt))
        row["library_dw_ms"] = time_ms(lambda: torch.bmm(xt, dyp))
    bound, bound_by = _gmm_bwd_bound_ms(e, gp, k, n, xp.element_size())
    row.update({"bound_ms": bound, "bound_by": bound_by,
                "pct_of_bound": 100.0 * bound / ms,
                "tflops": 4.0 * e * gp * k * n / ms / 1e9})
    split = "" if dtype != torch.bfloat16 else (
        f"; alone dX {row['dx_ms']:.4f} ms (torch.bmm "
        f"{row['library_dx_ms']:.4f}, bound {row['bound_dx_ms']:.4f}), dW "
        f"{row['dw_ms']:.4f} ms (torch.bmm {row['library_dw_ms']:.4f}, bound "
        f"{row['bound_dw_ms']:.4f})")
    print(f"  {what}: dx tiles {tiles['dx']}, dw tiles {tiles['dw']}; rel "
          f"err forward {fwd_err:.2e} dx {errs['dx']:.2e} dw "
          f"{errs['dw']:.2e} ok (experts "
          f"{sel if len(sel) < e else 'all'} of {e} gated), two calls "
          f"bit-equal; kernel "
          f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
          f"{row['pct_of_bound']:.1f} % of bound) | torch.bmm x2 "
          f"{library_ms:.4f} ms ({ms / library_ms:.2f}x) | plain "
          f"{plain_ms:.1f} ms on {len(sel)} experts | bound {bound:.4f} ms "
          f"({bound_by}){split}", flush=True)
    return row


def _parent_gmm_backward(src: str) -> list:
    """The grouped-matmul backward of the checkout whose ``src`` is given
    beside this one's, in turns (parent, this, this, parent, each a process
    of its own: ``src/repro_torch/benchmarks/gmm_backward.py --parent``),
    at the shapes of ``_gmm_backward_alone`` in bf16: each run's call ms
    and dX / dW device ms."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"  the parent's kernel ({src}) and this one in turns:", flush=True)
    proc = subprocess.run(
        [sys.executable, str(SRC / "repro_torch" / "benchmarks" /
                             "gmm_backward.py"), "--parent", src],
        capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise AssertionError(f"the parent's timing failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    print("\n".join(ln for ln in lines[:-1] if ln.startswith(("  ", "["))),
          flush=True)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return json.loads(lines[-1])["in_turns"]


def _train_model(dev, gen, arch: str, n_layers, index: int,
                 extra: dict | None = None) -> dict:
    """Phase 29 (b) (and 30 (b)) for one model: the step-1 gradient against
    the plain ops' step, then ``TrainLoop`` with every launch counter (and
    each of ``extra``, name -> an object with ``reset()`` and ``count``)
    set to 0 just before it and read just after, its tensors' addresses
    read before and after (the steps update them in place); one more step
    profiled."""
    import numpy as np
    import torch

    from repro_torch.configs import BF16_OPT_STATE, get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.tree import tree_paths

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    params = model.init(SEED + 10 + index)
    _fan_in_scaled(model, params)
    batch = {"tokens": torch.as_tensor(SyntheticStream(SyntheticConfig(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)).next_batch()["tokens"],
        device=dev)}
    if cfg.arch_kind == "encdec":
        batch["frames"] = torch.randn(
            (TRAIN_B, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev).to(cfg.dtype)
    kinds = [k for k, on in (
        ("flash_attention", any(d.kind == "attn" for d in cfg.block_pattern)),
        ("ssd_scan", any(d.kind != "attn" for d in cfg.block_pattern)),
        ("moe_gmm", any(d.moe for d in cfg.block_pattern))) if on]
    depth = "" if n_layers is None else f" (cut to {n_layers} layer)"
    moments = "bf16" if arch in BF16_OPT_STATE else "f32"
    print(f"  (b) {arch}{depth}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{model.param_count() / 1e9:.3f} B parameters, bf16, {moments} "
          f"AdamW moments, remat {cfg.remat!r}; kernels on its path: "
          f"{', '.join(kinds)}", flush=True)
    class PlainGmm(torch.autograd.Function):
        """``moe_gmm_plain`` with ``moe_gmm_backward_plain`` as its
        gradient: autograd through the plain version's sum over k would
        build a full-size gradient of w at every step of the sum (~100 s of
        qwen3-moe's plain steps)."""

        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return gmm.moe_gmm_plain(x, w)

        @staticmethod
        def backward(ctx, dy):
            return gmm.moe_gmm_backward_plain(*ctx.saved_tensors,
                                              dy.contiguous())

    plain = dict(attn_op=flash.flash_attention_plain,
                 ssd_op=ssd.ssd_scan_plain, gmm_op=PlainGmm.apply)

    routes, marks, replay = [], [], []
    real_route = L.moe_route

    def recording_route(c, p, xg):
        out = real_route(c, p, xg)
        routes.append(out[2])
        return out

    def replaying_route(c, p, xg):
        """The router's probabilities, with the experts the kernel step's
        route chose at the same call (gates renormalised as ``moe_route``
        does)."""
        probs = real_route(c, p, xg)[0]
        expert = replay.pop(0)
        gate = probs.gather(-1, expert)
        return (probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9), expert)

    def step1(mdl, tree, what: str, replayed: bool = False,
              **other) -> tuple:
        """(per-leaf rel difference, losses) of the kernels' step against
        the plain ops' (or ``other``'s) step; with ``replayed`` the second
        step routes as the first did."""
        start = len(routes)
        m_k, g_k = loss_and_grads(mdl, tree, batch)
        marks.append(len(routes))
        if replayed:
            replay[:] = routes[start:]
            L.moe_route = replaying_route
        m_p, g_p = loss_and_grads(mdl, tree, batch, **(other or plain))
        torch.cuda.synchronize()
        if replay:
            raise AssertionError(f"{arch} step 1: {len(replay)} recorded "
                                 f"routes were not replayed")
        for path, g in tree_paths(g_k):
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"{arch} step 1 ({what}): the gradient "
                                     f"of {path} is not finite and non-zero")
        rel = _leaf_rel(g_k, g_p)
        losses = (float(m_k["loss"]), float(m_p["loss"]))
        top = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        print(f"    step 1 ({what}): loss {losses[0]:.6f} (plain ops "
              f"{losses[1]:.6f}); {len(rel)} leaves finite and non-zero; "
              f"largest per-leaf max |d| / max |g|: "
              + ", ".join(f"{p} {r:.3e}" for p, r in top), flush=True)
        return rel, losses, top

    t_gate = time.perf_counter()
    replayed = arch in STEP1_REPLAYED_ROUTING
    L.moe_route = recording_route
    try:
        rel, (loss_k, loss_p), top = step1(
            model, params, "bf16, the kernels' routing replayed" if replayed
            else "bf16", replayed=replayed,
            **({"attn_op": flash.flash_attention_plain} if replayed else {}))
    finally:
        L.moe_route = real_route
    floor = None
    if routes and not replayed:
        agree = _routing_agreement(routes[0], routes[marks[0]])
        print(f"    bf16 routing of the two steps' first forward: "
              f"{agree[0]:.4%} of the (token, choice) pairs among the same "
              f"token's choices, {agree[1]:.4%} slot for slot", flush=True)
    if arch in STEP1_F32 and not routes:
        # the bf16 floor: the plain SSD at another chunk against the plain
        # step; then the gate's step in f32
        _, gf = loss_and_grads(model, params, batch, **{
            **plain, "ssd_op": functools.partial(ssd.ssd_scan_plain,
                                                 chunk=64)})
        _, gp = loss_and_grads(model, params, batch, **plain)
        floor = max(_leaf_rel(gf, gp).values())
        del gf, gp
        print(f"    bf16 floor (the plain SSD at chunk 64 against chunk "
              f"256): {floor:.3e} of max |g|; the gate holds the step in "
              f"f32", flush=True)
    if arch in STEP1_F32:
        model32 = Model(cfg.replace(dtype=torch.float32))
        rel, (loss_k, loss_p), top = step1(model32, _upcast(params), "f32")
        del model32
    gate_s = time.perf_counter() - t_gate
    print(f"    step-1 gate: {gate_s:.2f} s wall"
          + (f"; the plain step keeps the grouped matmul's kernel and "
             f"replays the kernel step's {marks[0]} routes (remat "
             f"{cfg.remat!r})" if replayed else ""), flush=True)
    if max(rel.values()) > 5e-2 or abs(loss_k - loss_p) > 1e-2 * abs(loss_p):
        raise AssertionError(f"{arch} step 1 disagrees with the plain-op "
                             f"step: {top}, loss {loss_k} vs {loss_p}")
    torch.cuda.empty_cache()
    preset = ShapePreset("chip", "train", TRAIN_S, TRAIN_B)
    opt_cfg = None
    if arch in BF16_OPT_STATE:    # TrainLoop's own schedule, bf16 moments
        opt_cfg = AdamWConfig(lr=warmup_cosine(5e-3, 10, 10_000),
                              weight_decay=0.01, state_dtype=torch.bfloat16)
    loop = TrainLoop(cfg, preset, seed=SEED, params=params, opt_cfg=opt_cfg)
    loop.init_state()
    loop.initial_params = params = None   # the loop trains its own copy
    counters = {**_train_more_counters(), **(extra or {})}

    def addresses() -> list:
        return [t.data_ptr() for t in _leaves(
            {"params": loop.params, **loop.opt_state})]

    before = addresses()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    hist = loop.run(TRAIN_MORE_STEPS, log_every=1)     # the main path
    launches = {k: c.count for k, c in counters.items()}
    flash_keys = list(flash.BACKWARD_LAUNCHES.tiles)
    gmm_keys = list(gmm.BACKWARD_LAUNCHES.tiles)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kept = addresses() == before
    if not kept:
        raise AssertionError(f"{arch}: the loop's parameter or moment "
                             f"tensors moved in {TRAIN_MORE_STEPS} steps: the "
                             f"update did not write them in place")
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: a training loss is not finite: "
                             f"{losses}")
    missing = [k for kind in kinds for k in (kind, kind + "_backward")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"{arch}: the training path launched no "
                             f"{missing}: {launches}")
    if arch.startswith("whisper") and not (
            any(not key[4] for key in flash_keys)
            and any(key[1] != key[2] for key in flash_keys)):
        raise AssertionError(f"whisper's training path ran no non-causal or "
                             f"no cross flash backward: {flash_keys}")
    if cfg.attn_softcap is not None:
        ran = flash.BACKWARD_LAUNCHES.tiles.get(
            (TRAIN_B * cfg.n_heads, TRAIN_S, TRAIN_S, cfg.head_dim, True))
        if ran != {"body": "wgmma", "capped": True}:
            raise AssertionError(f"{arch}: the training path's flash "
                                 f"backward ran {ran}, not the capped wgmma "
                                 f"body")
    if "moe_gmm" in kinds:
        G, _, C = L.moe_groups(cfg, TRAIN_B * TRAIN_S)
        rows = ops.gemm_dims(ops.gmm_kernel_name(cfg.dtype), {
            "e": cfg.n_experts, "g": G * C, "k": cfg.d_model,
            "n": cfg.moe_d_ff})["g"]
        if (cfg.n_experts, rows) not in {key[:2] for key in gmm_keys}:
            raise AssertionError(f"{arch}: the grouped-matmul backward ran "
                                 f"at {gmm_keys}, not at {cfg.n_experts} "
                                 f"experts x {rows} rows")
    step_ms = float(np.median([m["step_time_s"] for m in hist[1:]])) * 1e3
    batch = loop.next_batch()
    prof = _device_profile(
        lambda: loop.step_fn(loop.params, loop.opt_state, batch),
        f"one {arch} train step", groups=TRAIN_MORE_PROFILE_GROUPS,
        ranges=("adamw_update",))
    busy = prof["busy_ms"] / prof["wall_ms"] if prof else float("nan")
    print(f"    {TRAIN_MORE_STEPS} steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; ms per step (median "
          f"of steps 2-{TRAIN_MORE_STEPS}) {step_ms:.2f}, "
          f"{TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak:.2f} GiB, device busy {busy:.1%} of a profiled step; "
          f"launches per step: " + ", ".join(
              f"{k} {v / TRAIN_MORE_STEPS:g}" for k, v in launches.items()
              if v)
          + (f"; flash backward at (bh, sq, skv, d, causal) "
             f"{sorted(flash.BACKWARD_LAUNCHES.tiles.items())}"
             if cfg.attn_softcap is not None else "")
          + (f"; grouped-matmul backward at (e, g, k, n) "
             f"{sorted(gmm_keys)}" if "moe_gmm" in kinds else "")
          + f"; parameter and moment tensors at the same addresses after "
          f"the steps: {kept} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "n_layers": cfg.n_layers,
            "params_b": model.param_count() / 1e9, "step_ms": step_ms,
            "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
            "peak_gib": peak, "losses": losses,
            "moments": "bfloat16" if arch in BF16_OPT_STATE else "float32",
            "grad_norms": [m["grad_norm"] for m in hist],
            "step1_max_leaf_rel": max(rel.values()),
            "step1_dtype": "float32" if arch in STEP1_F32 else "bfloat16",
            "step1_bf16_floor": floor,
            "step1_loss": [loss_k, loss_p], "step1_gate_s": gate_s,
            "step1_routing_replayed": replayed,
            "in_place": kept, "busy_share": busy,
            "profile": prof, "launches": launches}


def train_more_phase(dev, gen, time_ms, phase_done, card: str) -> dict:
    """Phase 29: training beyond llama on the card.  (a) the SSD scan's and
    the grouped matmul's backward kernels alone at mamba2-130m's,
    qwen3-moe's and grok-1's training shapes (and the SSD's prefill shape);
    (b) ``TrainLoop`` on mamba2-130m, qwen3-moe (1 layer), internlm2-1.8b,
    whisper-medium and grok-1 (1 layer) at full width.  Returns the two
    backward kernels' rows of the ``kernels`` line and each kernel's
    launches on the five training paths, summed and by model."""
    import torch

    from repro_torch.core.kernel_spec import (SSD_SM90_CHUNKS,
                                              SSD_SM90_REGS_PER_THREAD,
                                              SSD_SM90_SHAPES)
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd

    t_phase = time.perf_counter()
    print("[29] training beyond llama on the card.  (a) the SSD scan's "
          "backward (csrc/ssd_scan_bwd.cu: one launch, the chain of state "
          "gradients in reverse chunk order, a fixed-order reduction; no "
          "atomics; bf16 at (64, 128) on the wgmma body, f32 on the SIMT "
          "body) and the grouped matmul's (csrc/gmm_bwd_sm90.cuh: dX and dW "
          "on a persistent wgmma body, the transposed operand read in place, "
          "a TMA-store epilogue) against their plain versions at "
          "mamba2-130m's, qwen3-moe's and grok-1's training shapes (gates: "
          "each gradient within 2e-2 (bf16) / 2e-4 (f32) x max |plain|; two "
          "calls bit-equal; the SSD forward bit-equal with its states; no "
          "spilled bytes)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        attrs = ssd.backward_attributes(dtype)
        print(f"  ssd_scan_bwd SIMT {str(dtype)[6:]}: {attrs}", flush=True)
        if attrs["local_bytes"]:
            raise AssertionError(f"the SSD backward spills: {attrs}")
    for dh, n in SSD_SM90_SHAPES:
        for chunk in SSD_SM90_CHUNKS:
            attrs = ssd.backward_tile_attributes(dh, n, chunk)
            smem = ssd.backward_tile_smem(dh, n, chunk)
            print(f"  ssd_scan_bwd bf16 wgmma (dh {dh}, n {n}) chunk "
                  f"{chunk}: {attrs}, {smem} bytes of shared memory (cap "
                  f"{SSD_SM90_REGS_PER_THREAD} registers)", flush=True)
            if attrs["num_regs"] > SSD_SM90_REGS_PER_THREAD \
                    or attrs["local_bytes"] \
                    or smem != ssd.backward_smem_bytes(chunk, n, 2, dh):
                raise AssertionError(
                    f"SSD backward wgmma chunk {chunk}: {attrs}, {smem} "
                    f"bytes against the cap {SSD_SM90_REGS_PER_THREAD}, no "
                    f"spills, and the wrapper's count "
                    f"{ssd.backward_smem_bytes(chunk, n, 2, dh)}")
    cap = gmm.MOE_GMM.regs_cap_for(torch.bfloat16)
    for product in gmm.PRODUCTS:
        attrs = {t: gmm.backward_attributes(product, *t)
                 for t in gmm.BACKWARD_SM90_TILES}
        print(f"  moe_gmm backward {product} (gmm_bwd_sm90) tiles (bm, bn): "
              f"registers / spilled bytes / shared memory (cap {cap}, "
              f"65536 / threads): " + ", ".join(
                  f"{t} {a['num_regs']}/{a['local_bytes']}/{a['smem_bytes']}"
                  for t, a in attrs.items()), flush=True)
        bad = {t: a for t, a in attrs.items()
               if a["num_regs"] > min(cap, 65536 // (2 * t[0]))
               or a["local_bytes"]
               or a["smem_bytes"] != gmm.backward_smem_bytes(*t)}
        if bad:
            raise AssertionError(f"moe_gmm backward {product}: {bad}")
    ssd_rows = _ssd_backward_alone(dev, gen, time_ms)
    gmm_rows = _gmm_backward_alone(dev, gen, time_ms)
    parent = _parent_gmm_backward(PARENT_SRC) if PARENT_SRC else None

    # -- (b) TrainLoop on the four models ------------------------------------
    print(f"  (b) TrainLoop at full width, bf16, B {TRAIN_B} x S {TRAIN_S} "
          f"from SyntheticStream, weights at std 1 / sqrt(fan-in), "
          f"{TRAIN_MORE_STEPS} steps each; first the step-1 gradient against "
          f"the same step with the plain ops (gates: every leaf finite and "
          f"non-zero, max |d| <= 5e-2 x max |g| per leaf, loss within 1e-2; "
          f"then finite losses and every forward and backward kernel of the "
          f"model's path launched)", flush=True)
    models = [_train_model(dev, gen, arch, n_layers, i)
              for i, (arch, n_layers) in enumerate(TRAIN_MORE)]
    launches = {name: sum(m["launches"][name] for m in models)
                for name in _train_more_counters()}
    by_model = {m["arch"]: m["launches"] for m in models}
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(29)
    print(json.dumps({"train_more": {"ssd_backward": ssd_rows,
                                     "gmm_backward": gmm_rows,
                                     "gmm_backward_parent": parent,
                                     "models": models},
                      "card": card}, default=str))
    out_rows = []
    for name, source, replaces, note, shapes in (
            ("ssd_scan_backward", "ssd_scan_bwd.cu",
             "src/repro/models/layers.py:355",
             "no TPU kernel: the JAX package differentiates ssd_parallel "
             "with XLA", ssd_rows),
            ("moe_gmm_backward", "moe_gmm.cu + gmm_bwd_sm90.cuh",
             "src/repro/kernels/ref.py:122",
             "no TPU kernel: the JAX package differentiates moe_gmm_ref "
             "with XLA; the top-level times are qwen3-moe's, grok-1's rows "
             "(its plain time on 2 experts) are in shapes", gmm_rows)):
        main = [r for r in shapes if r.get("in_totals", True)]
        out_rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "replaces_note": note,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "operations" if all(
                r["bound_by"] == "operations" for r in main) else "bytes",
            "library_ms": sum(r["library_ms"] for r in main)
            if name == "moe_gmm_backward" else None,
            "shapes": shapes})
    return {"rows": out_rows, "launches": launches, "by_model": by_model}


def _backward_without_cap_derivative(q, k, v, out, dout, lse, *,
                                     num_q_heads: int, num_kv_heads: int,
                                     causal: bool, window, softcap: float):
    """dq and dk of capped attention with dS = P (dP - delta), the cap's
    derivative left out (P from the capped score, as in
    ``flash_attention_backward_plain``): the control that shows phase
    30 (a)'s gate fails a kernel that drops it."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    bhq, sq, d = q.shape
    skv = k.shape[1]
    b, group, scale = bhq // num_q_heads, num_q_heads // num_kv_heads, \
        d ** -0.5
    qf, of, dof = (t.float().reshape(b, num_kv_heads, group, sq, d)
                   for t in (q, out, dout))
    kf, vf = (t.float().reshape(b, num_kv_heads, skv, d) for t in (k, v))
    l = lse.reshape(b, num_kv_heads, group, sq, 1)
    seen = flash._visible(sq, skv, causal, window, 0, 0, q.device) \
        & torch.isfinite(l)
    s = softcap * torch.tanh(
        torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * (scale / softcap))
    p = torch.exp(s - l.masked_fill(~torch.isfinite(l), 0.0)) \
        .masked_fill(~seen, 0.0)
    del s
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
              - (dof * of).sum(-1, keepdim=True))
    del p
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return dq.reshape(bhq, sq, d), dk.reshape(-1, skv, d)


def _masked_backward_alone(dev, gen, time_ms) -> tuple[list, float, dict]:
    """Phase 30 (a): the backward at each of ``MASKED_BWD_SHAPES`` against
    its plain version on the forward's output and lse, timed beside its
    bound and the plain version; then one profile of 10 calls at each
    bf16 shape.  With a softcap, q is scaled so that the scores scale q.k
    have std softcap / 2 and the cap bends them; two controls must then
    fail the same gate against the plain version: the plain backward with
    no cap (a kernel that ran its uncapped instantiation on the capped
    lse) and the one without the cap's derivative in dS.  Returns (rows,
    the largest absolute error, the profile's device time by kernel)."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    rows, calls = [], []
    worst = 0.0
    for name, B, S, hq, hkv, d, window, softcap, dt in MASKED_BWD_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        q = torch.randn(B * hq, S, d, generator=gen, device=dev)
        if softcap:
            q *= softcap / 2            # scores of std softcap / 2
        q = q.to(dtype)
        k, v = (torch.randn(B * hkv, S, d, generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        kw = dict(num_q_heads=hq, num_kv_heads=hkv, causal=True,
                  window=window, softcap=softcap)
        if dtype == torch.float32:
            tiles = dict(bq=32, bkv=64)
        else:
            tiles = dict(bq=64, bkv=64 if d == 256 else 128)
        out0 = flash.flash_attention_kernel(q, k, v, **tiles, **kw)
        out, lse = flash.flash_attention_kernel(q, k, v, **tiles, **kw,
                                                return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out, out0):
            raise AssertionError(f"{name}: the forward's output changed "
                                 f"when it also wrote lse")
        dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)

        def bwd(q=q, k=k, v=v, out=out, dout=dout, lse=lse, kw=kw):
            return flash.flash_attention_backward_kernel(q, k, v, out, dout,
                                                         lse, **kw)

        def plain(q=q, k=k, v=v, out=out, dout=dout, lse=lse, kw=kw):
            return flash.flash_attention_backward_plain(q, k, v, out, dout,
                                                        lse, **kw)

        got, again = bwd(), bwd()
        ran = flash.BACKWARD_LAUNCHES.tiles[(B * hq, S, S, d, True)]
        ref = plain()
        torch.cuda.synchronize()
        body = flash.backward_body(dtype, d)
        if ran["body"] != body or ran["capped"] != (softcap is not None):
            raise AssertionError(f"{name}: ran {ran}, not the {body} body "
                                 f"with capped={softcap is not None}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward calls differ")
        errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: non-finite {gname}")
            scale = float(r.float().abs().max())
            errs[gname] = float((g.float() - r.float()).abs().max()) / scale
            if not errs[gname] <= tol:
                raise AssertionError(f"{name}: {gname} differs from the "
                                     f"plain backward by {errs[gname]:.3e} "
                                     f"of max |plain| (gate {tol:g})")
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        worst = max(worst, err)
        del got, again
        controls = {}
        if softcap:
            uncapped = flash.flash_attention_backward_plain(
                q, k, v, out, dout, lse, **{**kw, "softcap": None})
            no_g = _backward_without_cap_derivative(q, k, v, out, dout, lse,
                                                    **kw)
            for cname, grads in (("uncapped", uncapped), ("no_g", no_g)):
                # non-finite (exp of uncapped scores overflows): recorded
                # as None, and it fails the gate
                e = max(float(torch.nan_to_num(
                    (c.float() - r.float()).abs().max(), nan=math.inf))
                        / float(r.float().abs().max())
                        for c, r in zip(grads, ref))
                controls[cname] = e if math.isfinite(e) else None
                if e <= tol:
                    raise AssertionError(
                        f"{name}: the {cname} control is within the gate "
                        f"({e:.3e} <= {tol:g}): the inputs do not exercise "
                        f"the cap")
            del uncapped, no_g
        del ref
        bound, bound_by = _bwd_bound_ms(B * hq, B * hkv, S, d, window,
                                        q.element_size())
        ms = time_ms(bwd)
        plain_ms = time_ms(plain, max_iters=1)
        row = {"shape": name, "bh": B * hq, "s": S, "d": d,
               "gqa": hq // hkv, "window": window, "softcap": softcap,
               "dtype": dt, "body": body, "rel_err": errs,
               "control_rel_err": controls,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "pct_of_bound": 100.0 * bound / ms, "library_ms": None}
        rows.append(row)
        print(f"  {name} (bh {B * hq}, S {S}, d {d}, GQA {hq // hkv}, "
              f"window {window}, softcap {softcap}, {dt}): rel err dq "
              f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} "
              f"ok, {body} body, two calls bit-equal"
              + "".join(f"; control {c} "
                        + ("non-finite" if e is None else f"{e:.3g}")
                        + " fails the gate" for c, e in controls.items())
              + f"; kernel {ms:.4f} ms "
              f"({row['pct_of_bound']:.1f} % of bound) | plain "
              f"{plain_ms:.3f} ms | bound {bound:.4f} ms ({bound_by}) | "
              f"library: none (SDPA takes no softcap)", flush=True)
        if dtype == torch.bfloat16:
            calls.append(bwd)
        del q, k, v, out, out0, lse, dout
        torch.cuda.empty_cache()

    def profiled():
        # as in phase 28 (a): host waits on both sides keep the calls clear
        # of the ends of the window, where the profiler loses kernels
        time.sleep(BWD_PROFILE_PAD_S)
        for fn in calls:
            for _ in range(BWD_PROFILE_CALLS):
                fn()
        torch.cuda.synchronize()
        time.sleep(BWD_PROFILE_PAD_S)

    prof = _device_profile(
        profiled, f"{BWD_PROFILE_CALLS} backward calls at each bf16 shape",
        groups=BWD_SPLIT_GROUPS, cpu=False)
    if not prof or not all(prof[g] > 0 for g, _ in BWD_SPLIT_GROUPS):
        raise AssertionError(f"the profile shows not all of the backward's "
                             f"kernels: {prof}")
    del calls
    torch.cuda.empty_cache()
    return rows, worst, prof


def gemma2_phase(dev, gen, time_ms, phase_done, card: str) -> dict:
    """Phase 30: gemma2-2b trained on the card.  (a) the flash-attention
    backward with the forward's softcap and window alone
    (``_masked_backward_alone``); (b) ``TrainLoop`` on gemma2-2b at full
    width (``_train_model``, the windowed launches read from the flash
    counters' ``windowed``);
    (c) one step at B 1 x S 8192 (``_long_context_step``).  Returns the
    backward's row of the ``kernels`` line for these paths and each flash
    kernel's launches on the training path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash

    t_phase = time.perf_counter()
    print(f"[30] {GEMMA2_ARCH} trained on the card.  (a) the flash-attention "
          f"backward with the forward's softcap and window "
          f"(csrc/flash_attention_bwd.cu: bf16 on the wgmma body, two dK / "
          f"dV warpgroups at d 256; f32 on the SIMT body) against "
          f"flash_attention_backward_plain at gemma2-2b's attention (8 / 4 "
          f"heads, d 256, softcap 50; global and window 4096) at S "
          f"{GEMMA2_S} and B {TRAIN_B} x S {TRAIN_S}, grok-1's (48 / 8 "
          f"heads, d 128, softcap 30) at S {PREFILL_S}, d 64 with a window "
          f"of 1024, and f32 at a small shape (gates: each of dq, dk, dv "
          f"within 2e-2 (bf16) / 2e-4 (f32) x max |plain|; the body; two "
          f"calls bit-equal; no spilled bytes in the wgmma kernels; the "
          f"profiler sees each of its three kernels)", flush=True)
    for d in flash.BACKWARD_HEAD_DIMS:
        attrs = {k: flash.backward_attributes(torch.bfloat16, d, k)
                 for k in flash.BACKWARD_KERNELS}
        attrs.update({f"{k}_softcap": flash.backward_attributes(
            torch.bfloat16, d, k, capped=True) for k in ("dkdv", "dq")})
        print(f"  registers / spilled bytes, bf16 wgmma body, d {d}: "
              + ", ".join(f"{k} {a['num_regs']} / {a['local_bytes']}"
                          for k, a in attrs.items()), flush=True)
        if any(a["local_bytes"] for a in attrs.values()):
            raise AssertionError(f"the wgmma backward spills at d {d}: "
                                 f"{attrs}")
    rows, worst, split = _masked_backward_alone(dev, gen, time_ms)

    # -- (b) TrainLoop on gemma2-2b at full width -----------------------------
    cfg = get_config(GEMMA2_ARCH)
    per_step = cfg.n_layers
    windowed_per_step = sum(
        cfg.block_pattern[i % len(cfg.block_pattern)].window is not None
        for i in range(cfg.n_layers))
    fwd_per_layer = 2 if cfg.remat == "full" else 1   # remat runs it again
    print(f"  (b) TrainLoop at full width, bf16, f32 AdamW moments, B "
          f"{TRAIN_B} x S {TRAIN_S} from SyntheticStream, weights at std 1 / "
          f"sqrt(fan-in), {TRAIN_MORE_STEPS} steps; gated as phase 29 (b), "
          f"and: {per_step} backward launches a step, {windowed_per_step} "
          f"of them windowed, and {fwd_per_layer * per_step} forward "
          f"launches a step (remat {cfg.remat!r}), "
          f"{fwd_per_layer * windowed_per_step} windowed", flush=True)
    model = _train_model(dev, gen, GEMMA2_ARCH, None, len(TRAIN_MORE),
                         extra={"flash_attention_windowed":
                                    flash.LAUNCHES.windowed,
                                "flash_attention_backward_windowed":
                                    flash.BACKWARD_LAUNCHES.windowed})
    launches = model["launches"]
    want = {"flash_attention": fwd_per_layer * per_step,
            "flash_attention_windowed": fwd_per_layer * windowed_per_step,
            "flash_attention_backward": per_step,
            "flash_attention_backward_windowed": windowed_per_step}
    got = {k: launches[k] / TRAIN_MORE_STEPS for k in want}
    if got != want:
        raise AssertionError(f"{GEMMA2_ARCH}: launches a step {got}, "
                             f"expected {want}")
    # -- (c) one step at S 8192 -----------------------------------------------
    long_step = _long_context_step(dev, flash, GEMMA2_ARCH, GEMMA2_S, "(c)",
                                   windowed=True)
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    phase_done(30)
    print(json.dumps({"gemma2": {"backward_alone": rows,
                                 "backward_split": split, "model": model,
                                 "long_context_step": long_step},
                      "card": card}, default=str))
    row = {
        "name": "flash_attention_backward_softcap_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:70",
        "replaces_note": "no TPU kernel: the JAX package differentiates "
                         "flash_attention_ref (window=, softcap=) with XLA",
        "launches": launches["flash_attention_backward"],
        "windowed_launches": launches["flash_attention_backward_windowed"],
        "long_context_launches": long_step["flash_bwd_launches"],
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in rows) else "bytes",
        "library_ms": None,
        "library_note": "none: SDPA takes no softcap",
        "shapes": rows,
    }
    return {"row": row, "launches": launches}



def distributed_phase(dev, gen, phase_done, card: str) -> dict:
    """Phase 31: ``distributed/`` on the card, NCCL at world size 1.  (a)
    the mesh and the sharder; (b) ``TrainLoop(mesh=)`` against
    ``TrainLoop(mesh=None)`` on llama3.2-1b and mamba2-130m; (c) the
    collectives on llama's step-1 gradient tree; (d) GPipe with one stage;
    (e) the elastic restore; (f) ``examples/serve_lm.py``.  Returns each
    path's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapePreset
    from repro_torch.data import SyntheticConfig, SyntheticStream
    from repro_torch.distributed import (Sharder, compressed_pmean,
                                         elastic_restore, gpipe_forward,
                                         hierarchical_pmean, train_rules)
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         mesh_chips)
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import Model, spec_leaves
    from repro_torch.models import transformer as T
    from repro_torch.optim import ef_compress_tree
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t_phase = time.perf_counter()
    # -- (a) the mesh ---------------------------------------------------------
    print("[31] distributed/ on the card, NCCL at world size 1.  (a) the "
          "mesh", flush=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    backend = dist.get_backend()
    if backend != "nccl":
        raise AssertionError(f"a cuda mesh runs {backend}, not nccl")
    llama = get_config("llama3.2-1b")
    specs = Model(llama, device=dev).specs()
    sh = Sharder(mesh, train_rules(fsdp=False))
    leaves = spec_leaves(specs)
    sharded = sum(any(e is not None for e in sh.param_sharding(s).spec)
                  for _, s in leaves)
    try:
        make_production_mesh()
    except ValueError as e:
        production = str(e)
    else:
        raise AssertionError("make_production_mesh ran at world size 1")
    if "256 ranks" not in production:
        raise AssertionError(f"make_production_mesh: {production}")
    print(f"  backend {backend}, world size {dist.get_world_size()}, "
          f"mesh_chips {mesh_chips(mesh)}; Sharder(train_rules(fsdp=False)) "
          f"over llama3.2-1b's {len(leaves)} full-width leaves: {sharded} "
          f"sharded (over axes of size 1), {len(sh.dropped)} dropped; "
          f"make_production_mesh(): {production}", flush=True)

    # -- (b) data-parallel training -------------------------------------------
    print(f"  (b) TrainLoop(mesh=make_mesh((1,), ('data',))) beside "
          f"TrainLoop(mesh=None), same seed and weights (std 1 / "
          f"sqrt(fan-in)), B {TRAIN_B} x S {TRAIN_S}, remat 'full', "
          f"{DP_STEPS} steps (gated: losses, grad norms and every parameter "
          f"and moment leaf bit-equal; each kernel's launches equal)",
          flush=True)
    dp_mesh = make_mesh((1,), ("data",))
    counters = _train_more_counters()
    preset = ShapePreset("chip", "train", TRAIN_S, TRAIN_B)
    dp_launches = dict.fromkeys(counters, 0)
    out = {"models": []}
    kept = None
    for arch in DP_ARCHS:
        cfg = get_config(arch)
        model = Model(cfg)
        params = model.init(SEED + 31)
        _fan_in_scaled(model, params)
        if arch == "llama3.2-1b":      # (c)'s gradient tree, step 1's batch
            batch = {"tokens": torch.as_tensor(SyntheticStream(
                SyntheticConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)
            ).next_batch()["tokens"], device=dev)}
            _, grads = loss_and_grads(model, params, batch)
        loops = {}
        for name, m in (("mesh=None", None), ("mesh", dp_mesh)):
            loop = TrainLoop(cfg, preset, mesh=m, seed=SEED, params=params)
            loop.init_state()
            torch.cuda.synchronize()
            for c in counters.values():
                c.reset()
            hist = loop.run(DP_STEPS, log_every=1)     # the main path
            launches = {k: c.count for k, c in counters.items()}
            loops[name] = (loop, hist, launches)
        del params
        (a, ha, la), (b, hb, lb) = loops["mesh=None"], loops["mesh"]
        for k in dp_launches:
            dp_launches[k] += lb[k]
        same = {k: [x[k] for x in ha] == [x[k] for x in hb]
                for k in ("loss", "grad_norm")}
        diff = [p for (p, x), (_, y) in zip(
            tree_paths({"params": a.params, **a.opt_state}),
            tree_paths({"params": b.params, **b.opt_state}))
            if not torch.equal(x, y)]
        kinds = [k for k in ("flash_attention", "ssd_scan")
                 if lb[k] or la[k]]
        ms = {name: float(np.median([x["step_time_s"] for x in h[1:]])) * 1e3
              for name, (_, h, _) in loops.items()}
        del a, loops
        gc.collect()
        torch.cuda.empty_cache()
        prof = _device_profile(
            lambda: b.step_fn(b.params, b.opt_state, b.next_batch()),
            f"one {arch} step on the mesh",
            groups=(("nccl", ("nccl",)),) + TRAIN_MORE_PROFILE_GROUPS)
        print(f"  {arch}: losses " + ", ".join(f"{x['loss']:.6f}"
                                             for x in hb)
              + f"; grad norms " + ", ".join(f"{x['grad_norm']:.6f}"
                                             for x in hb)
              + f"; bit-equal to mesh=None: losses {same['loss']}, grad "
              f"norms {same['grad_norm']}, {len(diff)} of "
              f"{len(tree_leaves(b.params)) * 2 + 1} state leaves differ; "
              f"launches a step (mesh / mesh=None): " + ", ".join(
                  f"{k} {lb[k] / DP_STEPS:g} / {la[k] / DP_STEPS:g}"
                  for k in counters if lb[k] or la[k])
              + f"; ms a step (median of steps 2-{DP_STEPS}) mesh "
              f"{ms['mesh']:.2f}, mesh=None {ms['mesh=None']:.2f}; NCCL "
              f"kernels in the profiled step {prof.get('nccl', 0.0):.4f} ms",
              flush=True)
        if not all(same.values()) or diff or la != lb or not kinds or any(
                not lb[k] or not lb[k + "_backward"] for k in kinds):
            raise AssertionError(f"{arch}: the mesh loop is not the "
                                 f"one-process loop: {same}, leaves {diff[:4]}"
                                 f", launches {lb} vs {la}")
        out["models"].append({
            "arch": arch, "losses": [x["loss"] for x in hb],
            "grad_norms": [x["grad_norm"] for x in hb],
            "ms_mesh": ms["mesh"], "ms_none": ms["mesh=None"],
            "nccl_ms": prof.get("nccl"), "profile": prof,
            "launches": lb})
        if arch == "llama3.2-1b":
            kept = (model, b)
        else:
            del b
        gc.collect()
        torch.cuda.empty_cache()
    model, loop = kept

    # -- (c) the collectives --------------------------------------------------
    pd = make_mesh((1, 1), ("pod", "data"))
    ref = tree_map(torch.clone, grads)
    exact = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(hierarchical_pmean(pd, grads)), tree_leaves(ref)))
    del grads
    worst, rounds = 0.0, []
    for path, g in tree_paths(ref):
        g32 = g.float()
        corrected = None
        for rnd in (1, 2):
            x = g32 if rnd == 1 else corrected
            mean, res = compressed_pmean(pd, {"g": x.clone()})
            mean, res = mean["g"], res["g"]
            scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
            q = torch.clamp(torch.round(x / scale), -127, 127)
            err = float(((mean - x).abs() / scale).max())
            worst = max(worst, err)
            if err > 0.5 + 127 * 2.0 ** -23 or \
                    not torch.equal(res, x - q * scale):
                raise AssertionError(f"compressed_pmean round {rnd} at "
                                     f"{path}: |mean - g| / scale {err}")
            if rnd == 1:
                corrected = g32 + res
                _, _, fold = ef_compress_tree({"g": g32}, {"g": res})
            elif not torch.equal(fold["g"], res):
                raise AssertionError(f"{path}: ef_compress_tree's residual "
                                     f"is not compressed_pmean's")
        del g32, corrected, mean, res, q
    del ref
    print(f"  (c) the collectives over a (pod 1, data 1) mesh on "
          f"llama3.2-1b's step-1 gradient tree: hierarchical_pmean "
          f"bit-equal to its input {exact}; compressed_pmean, two rounds "
          f"(the second on g + the first's residual, which "
          f"optim/compression.py's ef_compress_tree folds to the same "
          f"residual): max |mean - g| / scale {worst:.6f} (gated <= 0.5 + "
          f"two f32 roundings), residual = g - q * scale exactly", flush=True)
    if not exact:
        raise AssertionError("hierarchical_pmean over one rank changed the "
                             "gradients")

    # -- (d) GPipe, one stage -------------------------------------------------
    pipe = make_mesh((1,), ("pipe",))
    params = loop.params
    stage = {"blocks": tree_map(lambda p: p[None], params["blocks"]),
             "final_norm": params["final_norm"][None]}
    tokens = torch.randint(0, llama.vocab_size, (GPIPE_MICRO * GPIPE_B,
                                                  GPIPE_S),
                           generator=gen, device=dev)
    with torch.no_grad():
        x = T.embed_tokens(llama, params, tokens).reshape(
            GPIPE_MICRO, GPIPE_B, GPIPE_S, llama.d_model)
        flash.LAUNCHES.reset()
        got = gpipe_forward(lambda p, h: T.forward(llama, p, h)[0], stage, x,
                            pipe)
        gpipe_launches = flash.LAUNCHES.count
        want = torch.stack([T.forward(llama, params, x[m])[0]
                            for m in range(GPIPE_MICRO)])
    print(f"  (d) gpipe_forward over a (pipe 1) mesh: llama3.2-1b's "
          f"{llama.n_layers}-block stack as the stage, {GPIPE_MICRO} "
          f"microbatches of B {GPIPE_B} x S {GPIPE_S}: bit-equal to the stack "
          f"on each microbatch {torch.equal(got, want)}, flash launches "
          f"{gpipe_launches} (gated {llama.n_layers * GPIPE_MICRO})",
          flush=True)
    if not torch.equal(got, want) or \
            gpipe_launches != llama.n_layers * GPIPE_MICRO:
        raise AssertionError("gpipe_forward is not the stack on each "
                             "microbatch")
    del x, got, want, stage

    # -- (e) elastic restore --------------------------------------------------
    root = tempfile.mkdtemp(prefix="elastic-")
    try:
        t0 = time.perf_counter()
        CheckpointManager(root, async_save=False).save(DP_STEPS, params)
        save_s = time.perf_counter() - t0
        restored, _, step = elastic_restore(
            CheckpointManager(root), specs, Sharder(mesh, train_rules(False)),
            specs)
        same = [torch.equal(d.full_tensor(), params_leaf)
                and d.to_local().device.type == "cuda"
                for d, params_leaf in zip(tree_leaves(restored),
                                          tree_leaves(params))]
        del restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  (e) llama3.2-1b's parameters after (b) saved ({save_s:.2f} s) "
          f"and elastic_restore'd onto a (data 1, model 1) mesh: {sum(same)} "
          f"of {len(same)} DTensors bit-equal, on the card, step {step}",
          flush=True)
    if not all(same) or step != DP_STEPS:
        raise AssertionError("the elastic restore changed a leaf")
    del loop, params, kept, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- (f) examples/serve_lm.py ---------------------------------------------
    print("  (f) examples/serve_lm.py at full width (--no-smoke), sync and "
          "--async --trace", flush=True)
    root = tempfile.mkdtemp(prefix="serve_lm-")
    trace = os.path.join(root, "trace.json")
    args = ["--no-smoke", "--requests", "6", "--batch", "4", "--max-new",
            "4"]
    flash.LAUNCHES.reset()
    try:
        sync, e1 = serve_lm.main(args)               # the main path
        done, e2 = serve_lm.main(args + ["--async", "--trace", trace])
        eager = flash.LAUNCHES.count
        graphed = [e.graph_launches().get("flash_attention", 0)
                   for e in (e1, e2)]
        counts = [dict(e.compile_counts, captures=len(e.captures()))
                  for e in (e1, e2)]
        serve_launches = eager + sum(graphed)
        del e1, e2
        with open(trace) as f:
            spans = sum(ev.get("ph") == "X"
                        for ev in json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    greedy = [{r.rid: r.output for r in fin if r.temperature == 0}
              for fin in (sync, done)]
    served = [sorted(r.rid for r in fin) == list(range(6)) and all(
        r.done and r.output for r in fin) for fin in (sync, done)]
    # llama's serving steps run no hand-written kernel: every prompt token
    # and new token goes through the decode step, whose attention over the
    # cache is the reference's einsum (no Pallas kernel there either)
    print(f"  serve_lm: every request served {served}, greedy tokens equal "
          f"{greedy[0] == greedy[1]}, trace spans {spans}; step builds and "
          f"live captures (sync, async) {counts}; flash launches {eager} "
          f"eager + {graphed} in graph replays (the decode step's "
          f"attention is the reference's einsum)", flush=True)
    if not all(served) or greedy[0] != greedy[1] or not spans:
        raise AssertionError("serve_lm: a request was not served, the "
                             "greedy tokens differ or the trace is empty")
    wall = time.perf_counter() - t_phase
    print(f"  [31] wall {wall:.2f} s", flush=True)
    dist.destroy_process_group()
    phase_done(31)
    out.update({"dp_train_launches": dp_launches,
                "gpipe_launches": gpipe_launches,
                "serve_lm_launches": serve_launches,
                "compressed_max_err_over_scale": worst, "wall_s": wall})
    print(json.dumps({"distributed": out, "card": card}, default=str))
    return out

if __name__ == "__main__":
    sys.exit(main())
