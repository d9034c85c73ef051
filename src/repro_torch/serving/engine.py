"""Continuous-batching serving engine.

A fixed pool of ``batch`` decode slots shares one decode step (so shapes
never change).  Requests queue up; free slots are filled by prefilling the
prompt through the same decode step.  Finished sequences (EOS, their token
budget, or the end of the cache) free their slot immediately -- the decode
batch never drains, which is the continuous-batching property.  This is the
JAX package's ``ServingEngine``: the same slot bookkeeping, the same
greedy/sampled token choice, in PyTorch steps on the model's device.

Two front-ends share those slots:

* ``run()`` -- the synchronous baseline: the caller's thread alternates
  fill/decode, and prefill feeds the prompt token by token (one decode
  step per prompt token).
* ``start()`` / ``submit()`` / ``drain()`` (or the ``run_async()``
  convenience) -- the async front-end: a scheduler thread owns the device
  loop, ``submit`` is thread-safe and wakes it, and prefill runs *chunked*:
  the prompt advances in its descending power-of-two chunk split (cap
  ``prefill_chunk``), each chunk one step of c decode steps, so at most
  log2(prefill_chunk) + 1 prefill steps are ever built, however many prompt
  lengths arrive (slot and start position are device buffers, as they are
  traced operands in JAX).  An error in the scheduler thread stops it and
  is raised again by ``drain`` and ``run_async``.

**Steps are CUDA graphs on the card** (``serving/graphs.py``), the
counterpart of the JAX engine's ``jax.jit``: the decode step is one graph
over static token and position buffers and the cache, which the decode
step writes in place; each chunk size is one graph of c decode steps.  The
host copies the slots' arrays into the static buffers before each replay
and reads the static logits right after it.  A step's first call runs it
eagerly (the real step) and captures it; later calls replay.  A failed
capture raises -- there is no eager fallback.  All of an engine's device
work runs on one stream, and its graphs share one memory pool.  On the CPU
the same steps run eagerly.  ``compile_counts`` counts step builds: a
capture on the card, a step object per shape on the CPU -- so "one built
step serves every shape" is ``compile_counts["decode_step"] == 1`` across
a whole traffic mix, and chunked prefill builds at most
log2(prefill_chunk) + 1 steps.  Replacing ``cache`` drops the steps, as
their graphs hold the old cache's addresses.  A dropped step's graph is
released; its launches go on counting in ``graph_launches``, and the next
captures take a new memory pool.

At startup the engine warm-starts, from the persistent driver cache
(core/cache.py), the drivers of the kernels its model launches
(``decode_kernel_requests``) and of its ``auto_kernels``: the port's
read-through needs each kernel's spec.  ``plan_envelope=`` (kernel ->
per-data-param value lists) precompiles *launch plans* for the expected
traffic (core/plan.py), merged with the auto kernels' own envelopes.

``step_plans=True`` (default) builds a *per-step launch plan*
(core/step_plan.py): every kernel config the decode step needs, resolved in
one pass at engine start; every step is built and run under it, so the
step's ops read a frozen dict instead of the registry.  When the registry's
generation moves (a pinned override, a new driver), the plan goes stale,
and the next step rebuilds it and rebuilds (re-captures) every step, so
the new state takes effect at once -- the JAX docstring's "takes effect on
the very next trace" (the JAX ``jit`` itself never retraces for it).

Passing ``bucket_lattices=`` (kernel name -> ``core.buckets.BucketLattice``
or a prebuilt ``core.device_plan.BucketedDispatch``) opts the engine into
per-step bucket accounting: each decode step replays the bucket decision on
the host (bit-identical rounding) and counts hit/miss and padding waste in
``bucket_stats``.

For a shape with no cached driver, ``tune_for_shape`` runs a budgeted
online search on an oracle (``choose_or_default``'s opt-in escalation),
memoized per search configuration.

``trace=`` (a ``repro_torch.trace.Tracer``) and ``telemetry=`` (a
``repro_torch.telemetry.Telemetry``) are installed process-wide before
warm start, so the engine's bring-up lands in the flight recorder and
every decision its steps make is observed.  The spans ``engine.step``,
``engine.prefill``, ``engine.prefill_chunk`` and ``engine.decode`` sit
where the JAX engine's do; with a tracer installed, a step's span closes
only after the engine's stream has finished the step (the JAX engine
blocks on the step's output), so the span holds its device time.  A
decision made while a step is being captured defers its shadow probe
(telemetry/loop.py); the engine runs the deferred probes after every step,
on its stream, once the capture has ended.  A refit that swaps a driver
stales the step plan, and the next step rebuilds it and re-captures.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.driver import (WarmStartSummary, choose_or_default,
                           warm_start_from_cache)
from ..core.step_plan import use_step_plan
from ..trace import trace_span, tracing
from .graphs import StepGraph, graph_launches, on_stream
from .sampling import greedy, sample

__all__ = ["Request", "ServingEngine", "model_kernel_specs"]


def model_kernel_specs(cfg, batch: int, max_seq: int) -> list:
    """Specs of the tuned kernels a model's serving steps launch (those its
    ``decode_kernel_requests`` name), each once.  A kernel with no spec at
    this width (flash attention at a head dim it is not built for, as the
    smoke configs' 32) is left out."""
    from ..kernels.ops import kernel_spec
    from ..models.transformer import decode_kernel_requests

    specs = []
    for name in dict.fromkeys(r.kernel for r in decode_kernel_requests(
            cfg, batch, max_seq)):
        try:
            specs.append(kernel_spec(name, cfg.dtype))
        except ValueError:
            continue
    return specs


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    output: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params: dict, batch: int, max_seq: int,
                 eos_id: int = 1, seed: int = 0, warm_start: bool = True,
                 plan_envelope=None, auto_kernels=None,
                 step_plans: bool = True, prefill_chunk: int = 32,
                 bucket_lattices=None, trace=None, telemetry=None,
                 sharder=None):
        self.model = model
        self.params = params
        # the decode rules on the engine's mesh (``launch.serve.
        # build_engine(mesh=)``): every parameter replicated, so the steps
        # run as on one device
        self.sharder = sharder
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # The tracer and the telemetry loop each take a process-wide slot
        # (the tracer, the choice listener); the caller decides which
        # wins.  Installed first, so warm start and plan builds are seen.
        self.tracer = trace
        if trace is not None:
            trace.install()
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.install()
        # Introspected kernels served by this engine (repro_torch.introspect
        # AutoKernel instances): their drivers come through the same warm
        # start, and their traffic envelopes join the plan envelope.
        self.auto_kernels = list(auto_kernels or [])
        # Load tuned drivers (and persisted launch plans) of the kernels
        # this engine launches, so the first step already launches with
        # tuned parameters.
        self.warm_started: WarmStartSummary = (
            warm_start_from_cache(self._warm_start_specs()) if warm_start
            else WarmStartSummary())
        if telemetry is not None:
            telemetry.note_warm_start(self.warm_started)
        # Precompile launch plans over the declared traffic envelope:
        # kernel name -> {data param: candidate values}.  One choose_many
        # pass per kernel; kernels with no driver are skipped.
        self.plan_summary: dict = {"compiled": [], "loaded": [],
                                   "skipped": [], "entries": 0}
        envelope = dict(plan_envelope or {})
        for ak in self.auto_kernels:
            envelope.setdefault(ak.name, ak.plan_envelope())
        if envelope:
            from ..core.plan import precompile_plans
            self.plan_summary = precompile_plans(envelope)

        # Per-step bucket accounting: kernel name -> BucketedDispatch,
        # replayed host-side after each decode step.  Built before the step
        # plan: compiling a lattice's plan moves the registry's generation.
        self.bucket_stats = {"hits": 0, "misses": 0, "waste_sum": 0.0,
                             "steps": 0}
        self._bucket_dispatch = self._build_bucket_dispatch(bucket_lattices)

        # Per-step launch plan: every kernel config of the decode step,
        # frozen; steps are built under it and rebuilt when it goes stale.
        # Built for every model: the port's ops always take the kernels.
        self.step_plans = step_plans
        self._step_plan = None
        if step_plans:
            self._refresh_step_plan()

        # One stream for all of this engine's device work, and one memory
        # pool for its graphs; the stream waits for the parameters' init.
        self._stream = self._pool = None
        if self.device.type == "cuda":
            # "cuda" is the current device: the scheduler thread selects
            # this one, whatever device is current in that thread
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._pool = torch.cuda.graph_pool_handle()
        self._decode: StepGraph | None = None
        self._chunks: dict[int, StepGraph] = {}
        # kernel launches of the graphs dropped for a rebuild (the graphs
        # themselves are released)
        self._dropped_launches: dict[str, int] = {}
        with on_stream(self.device, self._stream):
            self.cache = model.init_cache(batch, max_seq)
        self.slot_req: list[Request | None] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)      # next write position
        self.slot_last = np.zeros(batch, np.int32)     # last emitted token
        self.slot_budget = np.zeros(batch, np.int32)
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self.steps = 0                                 # decode steps run

        # Async front-end state: one condition variable guards the pending
        # and finished queues (submit from any thread wakes the scheduler;
        # drain sleeps on it until the engine goes idle).
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._running = False
        self._max_steps = 10_000
        self._error: BaseException | None = None
        self._filling: Request | None = None    # popped, being prefilled

        # Step builds: a capture on the card, a step object on the CPU.
        self.compile_counts = {"decode_step": 0, "prefill_chunk": 0}

    # -- the cache the steps are built over -------------------------------------
    @property
    def cache(self) -> dict:
        return self._cache

    @cache.setter
    def cache(self, value: dict) -> None:
        """A new cache drops every built step (their graphs hold the old
        cache's addresses); the next call of each builds it again."""
        self._cache = value
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._drop_steps()

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request; thread-safe, wakes the scheduler if running."""
        with self._cv:
            self.pending.append(req)
            self._cv.notify_all()

    def start(self) -> None:
        """Start the async scheduler thread (idempotent)."""
        if self._thread is not None:
            return
        self._running = True
        self._error = None
        self._thread = threading.Thread(
            target=self._scheduler_loop, daemon=True, name="engine-scheduler")
        self._thread.start()

    def stop(self) -> None:
        """Stop the scheduler thread and join it."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def drain(self, timeout: float | None = None) -> list[Request]:
        """Block until every submitted request has finished (or timeout);
        raises what stopped the scheduler thread, if anything did."""
        with self._cv:
            self._cv.wait_for(
                lambda: not self._running or not self._has_work(), timeout)
            if self._error is not None:
                raise RuntimeError("the engine's scheduler thread failed"
                                   ) from self._error
            return list(self.finished)

    def run_async(self, max_steps: int = 10_000) -> list[Request]:
        """Async-front-end analogue of ``run``: start, drain, stop."""
        self._max_steps = max_steps
        self.start()
        try:
            self.drain()
        finally:
            self.stop()
        return self.finished

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Fill free slots and decode until every request is done (or
        ``max_steps`` fill-and-decode rounds); returns finished requests."""
        rounds = 0
        while self._has_work() and rounds < max_steps:
            self._fill_slots()
            self._decode_once()
            rounds += 1
        return self.finished

    def tune_for_shape(self, spec, D, device, strategy="surrogate",
                       budget=None, hw=None) -> dict[str, int]:
        """Launch parameters for a shape with no cached driver.

        ``choose_or_default``'s opt-in escalation: the registered or cached
        driver when one decides the shape, else a budgeted online search
        on the oracle ``device`` (``CudaEventTimer`` on the card), memoized
        per (kernel, hw, shape, strategy, budget), so a serving process
        pays at most one bounded search per shape and search configuration.
        A driver that raises on the shape (built for other data parameters)
        is searched past.  ``strategy`` and ``budget`` are
        ``repro_torch.search`` settings (default: the surrogate under
        ``default_budget``); ``hw`` defaults to the oracle's.  Raises
        ``ValueError`` when nothing is tuned and nothing can be searched.
        """
        hw = hw if hw is not None else device.hw
        miss = {"__untuned__": -1}
        cfg = choose_or_default(spec.name, D, miss, spec=spec, hw=hw,
                                device=device, strategy=strategy,
                                budget=budget)
        if cfg == miss:
            raise ValueError(
                f"no tuned or searchable config for {spec.name} at {D}")
        return cfg

    def graph_launches(self) -> dict[str, int]:
        """Kernel launches made by this engine's graph replays, by kernel
        (each graph's launches per replay, recorded at its capture, times
        its replays; those of graphs dropped for a rebuild included).
        Eager steps count in the kernels' own ``LAUNCHES``."""
        out = dict(self._dropped_launches)
        for k, n in graph_launches(self._built_steps()).items():
            out[k] = out.get(k, 0) + n
        return out

    def captures(self) -> list[StepGraph]:
        """The live steps that hold a graph (none on the CPU); a dropped
        graph is released, and counts on in ``compile_counts`` and
        ``graph_launches``."""
        return [s for s in self._built_steps() if s.graph is not None]

    # -- internals ------------------------------------------------------------
    def _has_work(self) -> bool:
        return (bool(self.pending) or self._filling is not None
                or any(r is not None for r in self.slot_req))

    def _scheduler_loop(self) -> None:
        """Async device loop: fill free slots (chunked prefill), decode,
        notify waiters; sleep on the condition variable when idle so a
        ``submit`` wakes it immediately."""
        steps = 0
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self._cuda_index)
            while True:
                with self._cv:
                    if not self._running:
                        return
                    if steps >= self._max_steps:
                        self._running = False
                        self._cv.notify_all()
                        return
                    if not self._has_work():
                        self._cv.notify_all()
                        self._cv.wait(0.05)
                        continue
                self._fill_slots(chunked=True)
                self._decode_once()
                steps += 1
                with self._cv:
                    self._cv.notify_all()
        except BaseException as e:          # raised again by drain()
            with self._cv:
                self._error = e
                self._running = False
                self._cv.notify_all()

    def _warm_start_specs(self) -> list:
        """Specs of the kernels the model's steps launch, and of the auto
        kernels (the driver cache is keyed by spec)."""
        return model_kernel_specs(self.model.cfg, self.batch, self.max_seq) \
            + [ak.spec for ak in self.auto_kernels]

    def _build_bucket_dispatch(self, bucket_lattices) -> dict:
        """kernel -> BucketedDispatch from the ``bucket_lattices=`` arg.

        Prebuilt ``BucketedDispatch`` values pass through; bare
        ``BucketLattice`` values get a dispatch built over whatever plan
        the registry holds (empty table -> every step is a default-branch
        miss, which the stats then show).  Default configs come from the
        model's own kernel requests, else the ops' defaults.
        """
        if not bucket_lattices:
            return {}
        from ..core.device_plan import (BucketedDispatch,
                                        build_bucketed_dispatch)
        from ..models.transformer import decode_kernel_requests

        defaults: dict[str, dict] = {}
        for kr in decode_kernel_requests(self.model.cfg, self.batch,
                                         self.max_seq):
            defaults.setdefault(kr.kernel, dict(kr.default))
        out: dict = {}
        for kernel, lat in bucket_lattices.items():
            if isinstance(lat, BucketedDispatch):
                out[kernel] = lat
                continue
            default = defaults.get(kernel) or self._heuristic_default(kernel)
            if default is None:
                continue
            out[kernel] = build_bucketed_dispatch(kernel, lat, default,
                                                  device=self.device)
        return out

    @staticmethod
    def _heuristic_default(kernel: str) -> dict | None:
        from ..introspect import get_auto
        from ..kernels import ops as _ops

        ak = get_auto(kernel)
        if ak is not None:
            return dict(ak.defaults)
        for prefix, default in (("matmul_b32", _ops.MATMUL_DEFAULT_F32),
                                ("matmul", _ops.MATMUL_DEFAULT),
                                ("flash", _ops.FLASH_DEFAULT),
                                ("moe_gmm_b32", _ops.GMM_DEFAULT_F32),
                                ("moe", _ops.GMM_DEFAULT),
                                ("ssd", _ops.SSD_DEFAULT)):
            if kernel.startswith(prefix):
                return dict(default)
        return None

    def _note_bucket_stats(self, active: list[int]) -> None:
        """Host replay of the bucket decision for this step's effective
        sequence length; bit-identical to the device decision by
        construction (BucketLattice shares the rounding arithmetic)."""
        if not self._bucket_dispatch:
            return
        from ..models.transformer import decode_kernel_requests

        eff = int(max(self.slot_pos[s] for s in active)) + 1
        Ds: dict[str, dict] = {}
        for kr in decode_kernel_requests(self.model.cfg, self.batch,
                                         self.max_seq, seqs=(eff,)):
            Ds.setdefault(kr.kernel, dict(kr.D))
        for kernel, disp in self._bucket_dispatch.items():
            D = Ds.get(kernel)
            if D is None:
                continue
            hit, waste = disp.observe(D)
            self.bucket_stats["hits" if hit else "misses"] += 1
            self.bucket_stats["waste_sum"] += waste
            if self.telemetry is not None:
                self.telemetry.note_bucket_step(hit, waste, kernel=kernel)
        self.bucket_stats["steps"] += 1

    def _refresh_step_plan(self) -> None:
        from ..core.step_plan import build_step_plan
        from ..models.transformer import decode_kernel_requests

        self._step_plan = build_step_plan(decode_kernel_requests(
            self.model.cfg, self.batch, self.max_seq))

    def _built_steps(self) -> list[StepGraph]:
        return ([self._decode] if self._decode is not None else []) \
            + list(self._chunks.values())

    def _drop_steps(self) -> None:
        """Release every built step, keeping only its graph's launches.
        After graphs are released the next captures take a new memory
        pool: a pool whose graphs are all released cannot take another
        capture."""
        released = self.captures()
        self._dropped_launches = self.graph_launches()
        self._decode = None
        self._chunks = {}
        if released and self._pool is not None:
            self._pool = torch.cuda.graph_pool_handle()

    def _check_plan(self) -> None:
        """A stale step plan is rebuilt, and so is every step: each was
        built (captured) under the old plan's configs."""
        if self._step_plan is not None and self._step_plan.stale():
            self._refresh_step_plan()
            self._drop_steps()

    def _counted(self, kind: str):
        def built() -> None:
            self.compile_counts[kind] += 1
        return built

    def _new_step(self, kind: str, fn) -> StepGraph:
        return StepGraph(fn, self.device, self._stream, self._pool,
                         on_build=self._counted(kind))

    def _inputs(self, n: int) -> torch.Tensor:
        with on_stream(self.device, self._stream):
            return torch.zeros(n, dtype=torch.int32, device=self.device)

    def _build_decode(self) -> StepGraph:
        """The decode step over a static (2 * batch,) int32 buffer: the
        slots' tokens, then their positions."""
        B = self.batch
        buf = self._inputs(2 * B)
        token, pos = buf[:B], buf[B:]

        def decode() -> torch.Tensor:
            logits, _ = self.model.decode_step(self.params, token, pos,
                                               self.cache)
            return logits

        step = self._new_step("decode_step", decode)
        step.inputs = buf
        return step

    def _build_chunk(self, c: int) -> StepGraph:
        """One prefill chunk of ``c`` decode steps over a static int32
        buffer: the chunk's tokens, slot, pos0, then the base token and
        position vectors.  Lane i writes the slot's position pos0 + i with
        tokens[i]; the other slots rewrite their own current position with
        their own last token, as the JAX scan body does (idempotent for a
        KV cache; a Mamba block's state advances in every slot, the
        reference's leak).  The power-of-two split fills every lane, so no
        lane is masked."""
        B = self.batch
        buf = self._inputs(c + 2 + 2 * B)
        tokens, slot, pos0 = buf[:c], buf[c], buf[c + 1]
        base_tok, base_pos = buf[c + 2:c + 2 + B], buf[c + 2 + B:]
        with on_stream(self.device, self._stream):
            lanes = torch.arange(B, dtype=torch.int32, device=self.device)

        def chunk() -> None:
            sel = lanes == slot
            for i in range(c):
                self.model.decode_step(
                    self.params, torch.where(sel, tokens[i], base_tok),
                    torch.where(sel, pos0 + i, base_pos), self.cache,
                    logits=False)

        step = self._new_step("prefill_chunk", chunk)
        step.inputs = buf
        return step

    def _call(self, step: StepGraph, values: np.ndarray):
        """Copy ``values`` into the step's static buffer, then run it (on
        the engine's stream, under the step plan), ordered after the
        caller's stream and before its next work."""
        plan = (use_step_plan(self._step_plan)
                if self._step_plan is not None else contextlib.nullcontext())
        caller = None
        if self._stream is not None:
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
        with on_stream(self.device, self._stream):
            step.inputs.copy_(torch.from_numpy(values.astype(np.int32)))
            with plan:
                out = step()
            if self.telemetry is not None:
                # probes deferred by a capture this step ended
                self.telemetry.drain_deferred()
            if self._stream is not None and tracing():
                # the step's span holds its device time
                self._stream.synchronize()
        if caller is not None:
            caller.wait_stream(self._stream)
            if isinstance(out, torch.Tensor) and out is not step.output:
                out.record_stream(caller)
        return out

    def _run_step(self, tok: np.ndarray, ps: np.ndarray) -> torch.Tensor:
        """One decode step of every slot; returns the logits (on the card,
        the graph's static output: read before the next step)."""
        self._check_plan()
        if self._decode is None:
            self._decode = self._build_decode()
        with trace_span("engine.step",
                        step_plan=self._step_plan is not None):
            return self._call(self._decode, np.concatenate([tok, ps]))

    def _fill_slots(self, chunked: bool = False) -> None:
        for s in range(self.batch):
            if self.slot_req[s] is not None:
                continue
            with self._cv:
                if not self.pending:
                    break
                # in flight until it holds its slot, so drain() does not
                # take the engine for idle meanwhile
                req = self._filling = self.pending.pop(0)
            # prefill the prompt through the shared decode step
            with trace_span("engine.prefill", rid=req.rid,
                            tokens=len(req.prompt) - 1, chunked=chunked):
                if chunked:
                    self._prefill_chunked(s, req.prompt)
                else:
                    for t_idx, tok in enumerate(req.prompt[:-1]):
                        self._single(s, tok, t_idx)
            self.slot_pos[s] = len(req.prompt) - 1
            self.slot_last[s] = req.prompt[-1]
            self.slot_budget[s] = req.max_new_tokens
            with self._cv:
                self.slot_req[s] = req
                self._filling = None

    @staticmethod
    def _pow2_chunks(n: int, cmax: int) -> list[int]:
        """Descending powers of two summing to ``n``, each <= ``cmax``.

        Log2-bucketed chunk lengths (the same rounding the bucket lattice
        uses for data params): the chunks compute exactly ``n`` lanes --
        no masked tail lanes re-running decode steps -- at the cost of at
        most ``log2(cmax) + 1`` distinct chunk shapes, each built once
        for the life of the engine.
        """
        out = []
        c = 1
        while c * 2 <= max(1, cmax):
            c *= 2
        while n > 0:
            while c > n:
                c //= 2
            out.append(c)
            n -= c
        return out

    def _prefill_chunked(self, slot: int, prompt: list[int]) -> None:
        """Prefill ``prompt[:-1]`` in chunks: one step call per chunk
        instead of one per token, chunk lengths the descending power-of-two
        split of the prompt (cap ``prefill_chunk``).  No host block beyond
        the input copy -- the cache stays on the device and the next step
        queues behind it."""
        toks = prompt[:-1]
        base_tok = np.array(self.slot_last, np.int32)
        base_pos = np.array(self.slot_pos, np.int32)
        t0 = 0
        for c in self._pow2_chunks(len(toks), self.prefill_chunk):
            buf = np.asarray(toks[t0:t0 + c], np.int32)
            self._run_prefill(buf, slot, t0, base_tok, base_pos)
            t0 += c

    def _run_prefill(self, tokens: np.ndarray, slot: int, pos0: int,
                     base_tok: np.ndarray, base_pos: np.ndarray) -> None:
        """One chunked-prefill step of ``len(tokens)`` lanes (same
        staleness contract as ``_run_step``)."""
        self._check_plan()
        c = len(tokens)
        step = self._chunks.get(c)
        if step is None:
            step = self._chunks[c] = self._build_chunk(c)
        with trace_span("engine.prefill_chunk", slot=int(slot), n_valid=c):
            self._call(step, np.concatenate(
                [tokens, [slot, pos0], base_tok, base_pos]))

    def _single(self, slot: int, token: int, pos: int) -> None:
        """One prompt token of ``slot``, through a step of every slot, as
        the JAX engine does.  The other slots rewrite their own current
        position with their own last token: idempotent for a KV cache, but
        a Mamba-2 block's conv and SSM states advance in every slot at
        every step (a fault of the reference the port reproduces)."""
        tok = np.array(self.slot_last, np.int32)
        ps = np.array(self.slot_pos, np.int32)
        tok[slot] = token
        ps[slot] = pos
        self._run_step(tok, ps)

    def _decode_once(self) -> None:
        active = [s for s in range(self.batch) if self.slot_req[s] is not None]
        if not active:
            return
        with trace_span("engine.decode", active=len(active)):
            logits = self._run_step(self.slot_last, self.slot_pos)
            self.steps += 1
            temps = {r.temperature for r in self.slot_req if r is not None}
            with on_stream(self.device, self._stream):
                greedy_tok = greedy(logits).cpu().numpy()
                sampled_tok = sample(logits, self.generator,
                                     temperature=max(temps | {1.0})
                                     ).cpu().numpy()
            self._note_bucket_stats(active)
            for s in active:
                req = self.slot_req[s]
                nxt = int(greedy_tok[s] if req.temperature <= 0.0
                          else sampled_tok[s])
                req.output.append(nxt)
                self.slot_pos[s] += 1
                self.slot_last[s] = nxt
                self.slot_budget[s] -= 1
                if (nxt == self.eos_id or self.slot_budget[s] <= 0
                        or self.slot_pos[s] >= self.max_seq - 1):
                    req.done = True
                    with self._cv:
                        self.finished.append(req)
                        self.slot_req[s] = None  # freed: continuous batching
                        self._cv.notify_all()
