"""Serving launcher: build a continuous-batching engine for one config.

    from repro_torch.configs import get_config
    from repro_torch.launch import build_engine
    from repro_torch.serving import Request

    engine = build_engine(get_config("llama3.2-1b"), batch=4, max_seq=256)
    engine.submit(Request(rid=0, prompt=[5, 17, 42], max_new_tokens=16))
    done = engine.run()

The engine runs on the card unless the caller passes ``device="cpu"``.
``mesh=`` (a mesh of ``launch.mesh.make_mesh``) gives the engine the
reference's decode rules on it (``engine.sharder``); a mesh whose "model"
or "pipe" axis is larger than 1, or that would shard a parameter, raises
``NotImplementedError`` (ROADMAP Queue A item 6.4.4).

From the command line (random weights from a seed):

    python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8 \\
        --max-new 12 --auto-kernels

``--auto-kernels`` introspects the auto-specced kernels (the fused
layernorm + residual at the config's d_model and the blocked column sum),
tunes each against the card (``CudaEventTimer``; ``HopperModel`` only with
``--device cpu``) and prints one line per kernel before serving.
``--plans`` precompiles launch plans over ``default_plan_envelope``,
``--no-step-plans`` turns the engine's per-step launch plan off,
``--async`` serves through the async front-end (a scheduler thread and
chunked prefill of ``--prefill-chunk`` tokens at most) and ``--buckets``
counts the decode attention kernel's bucket hits and padding waste over
``default_bucket_lattices``; each prints what the JAX launcher prints for
it.

``--telemetry`` installs the observability and retuning loop
(``repro_torch.telemetry``) over the specs of the kernels the model's
steps launch and the auto kernels', probing on the card
(``CudaEventTimer``; ``HopperModel`` only with ``--device cpu``), and
prints its Prometheus text after the run; ``--telemetry-json PATH`` writes
the JSON snapshot instead.  ``--trace PATH`` records spans for the whole
run and writes a Chrome trace-event file (open it in ui.perfetto.dev);
``--ledger PATH`` appends the flight ledger (choices, probes, drift,
refits and, with ``--trace``, spans; implies ``--telemetry``) and points
at ``python -m repro_torch.launch.status`` and ``python -m
repro_torch.launch.fleet retune`` to read it.  The JAX launcher's
``--dash`` waits for ``launch/dash.py`` (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import argparse
from typing import Sequence

import torch

from ..configs import get_config
from ..distributed.sharding import Sharder, decode_rules
from ..models import Model
from ..models.config import ModelConfig
from ..serving.engine import Request, ServingEngine, model_kernel_specs

__all__ = ["build_auto_kernels", "build_engine", "build_telemetry",
           "default_bucket_lattices", "default_plan_envelope", "main",
           "pow2_seqs"]


def build_engine(cfg: ModelConfig, batch: int, max_seq: int,
                 mesh=None, params: dict | None = None, seed: int = 0,
                 eos_id: int = 1,
                 device: str | torch.device = "cuda",
                 plan_envelope=None, auto_kernels=None,
                 step_plans: bool = True, prefill_chunk: int = 32,
                 bucket_lattices=None, trace=None,
                 telemetry=None) -> ServingEngine:
    """An engine over ``cfg`` with ``params`` (seeded random weights if
    None) on ``device``, with ``Sharder(mesh, decode_rules())``; the other
    arguments are ``ServingEngine``'s."""
    sharder = Sharder(mesh=mesh, rules=decode_rules())
    model = Model(cfg, device=device)
    sharder.check_runnable(model.specs(), "serving")
    if params is None:
        params = model.init(seed)
    return ServingEngine(model, params, batch=batch, max_seq=max_seq,
                         eos_id=eos_id, seed=seed,
                         plan_envelope=plan_envelope,
                         auto_kernels=auto_kernels, step_plans=step_plans,
                         prefill_chunk=prefill_chunk,
                         bucket_lattices=bucket_lattices, trace=trace,
                         telemetry=telemetry, sharder=sharder)


def build_telemetry(seed: int = 0, auto_kernels=(), ledger=None,
                    device: str | torch.device = "cuda", specs=()):
    """Serving telemetry over ``specs`` (the model's kernel specs,
    ``serving.engine.model_kernel_specs``) and the auto kernels' specs,
    shadow-probing on the card (``CudaEventTimer``) or, with
    ``device="cpu"``, on ``HopperModel``.  ``ledger`` (a path or a
    ``repro_torch.trace.Ledger``) appends every choice, probe, drift and
    refit to the JSONL flight ledger."""
    from ..core.device_model import CudaEventTimer, HopperModel
    from ..telemetry import Telemetry

    oracle = (HopperModel(seed=seed) if torch.device(device).type == "cpu"
              else CudaEventTimer(device=device, seed=seed))
    return Telemetry(list(specs) + [ak.spec for ak in auto_kernels], oracle,
                     seed=seed, ledger=ledger)


def default_bucket_lattices(cfg: ModelConfig, batch: int,
                            max_seq: int) -> dict:
    """Bucket lattices for the decode step's attention kernel: log2 seq
    buckets up to ``max_seq``, fixed batch-heads axis.  The engine replays
    these per step for hit/miss and padding-waste accounting (and they are
    the lattices a bucketed attention step would pad to)."""
    from ..core import BucketLattice
    from ..kernels.ops import flash_kernel_name

    key = flash_kernel_name(cfg.head_dim, cfg.causal)
    return {key: BucketLattice.from_axes(key, {
        "bh": [batch * cfg.n_heads],
        "sq": pow2_seqs(max_seq),
        "skv": pow2_seqs(max_seq),
    })}


def pow2_seqs(max_seq: int) -> list[int]:
    from ..core import pow2_span
    return list(pow2_span(1, max_seq))


def default_plan_envelope(batch: int, max_seq: int) -> dict:
    """The serving traffic envelope of the tier-1 kernels, as per-data-param
    value lists (what ``core.plan.precompile_plans`` compiles in one
    ``choose_many`` pass per kernel): the JAX package's lattice, with the
    matmul's m rounded up to the bf16 kernel's granule, as ``ops.matmul``
    pads it before it resolves (``ops.gemm_dims``), so the plan's shapes
    are the ones the op asks for.  Infeasible points are dropped when the
    plan is compiled, so a wide envelope costs only table entries."""
    from ..kernels.ops import gemm_dims

    seqs = [s for s in (128, 256, 512, 1024, 2048, 4096)
            if s <= max_seq] or [max_seq]
    dims = [1024, 2048, 4096]
    heads = sorted({max(1, batch) * h for h in (8, 16, 32)})
    ms = sorted({gemm_dims("matmul_b16", {"m": m})["m"]
                 for m in (max(8, batch), 128, 1024)})
    return {
        "matmul_b16": {"m": ms, "n": dims, "k": dims},
        "flash_attn_d128_causal": {"bh": heads, "sq": seqs, "skv": seqs},
        "moe_gmm_b16": {"e": [8], "g": [256, 512, 1024],
                        "k": [1024, 2048], "n": [1024, 2048]},
        "ssd_scan_h64_n128": {"bh": heads, "s": seqs, "chunkflops": [1]},
    }


# Configurations probed at each probe size of an auto kernel: all nine of the
# layernorm's row tiles (a sample of eight left one out at each size, at r
# 8192 the only probe of many small CTAs, br 8), twelve of the column sum's
# 36 tiles.
AUTO_PROBES_PER_SIZE = 12


def build_auto_kernels(d_model: int = 1024, tune_device=None,
                       device: str | torch.device = "cuda"):
    """Introspect the auto-specced kernels (layernorm fusion at ``d_model``,
    blocked column reduction) -- no hand-written spec code.

    Registers come from the compiled kernels on a CUDA ``device`` and from
    their ``__launch_bounds__`` caps with ``device="cpu"``.  With
    ``tune_device`` (a DeviceModel) each kernel that has no registered
    driver gets one built immediately (collect -> fit -> codegen); otherwise
    dispatch uses the kernels' defaults until one is built.
    """
    from ..introspect import auto_register
    from ..kernels.layernorm import LAYERNORM, layernorm_grid_spec
    from ..kernels.reduce import COLSUM, colsum_grid_spec

    kernels = [
        auto_register(LAYERNORM, layernorm_grid_spec(d_model),
                      device=device),
        auto_register(COLSUM, colsum_grid_spec(), device=device),
    ]
    if tune_device is not None:
        for ak in kernels:
            ak.ensure_driver(tune_device, repeats=2,
                             max_configs_per_size=AUTO_PROBES_PER_SIZE)
    return kernels


def main(argv: Sequence[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a few requests of one config with random weights.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--plans", action="store_true",
                    help="precompile launch plans for the default decode "
                         "traffic envelope at warm start (O(1) dispatch)")
    ap.add_argument("--no-step-plans", action="store_true",
                    help="disable the per-step launch plan (every kernel "
                         "dispatch of a step build goes through the "
                         "registry instead of the engine's frozen per-step "
                         "config table)")
    ap.add_argument("--auto-kernels", action="store_true",
                    help="introspect + tune the auto-specced kernels "
                         "(layernorm fusion, blocked column reduction) and "
                         "serve them through the engine: zero hand-written "
                         "spec code")
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="serve through the async front-end (scheduler "
                         "thread + chunked prefill) instead of the "
                         "synchronous loop")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens advanced per prefill step on the "
                         "async path (default 32)")
    ap.add_argument("--buckets", action="store_true",
                    help="enable per-step bucketed-dispatch accounting for "
                         "the decode attention kernel (hit/miss + padding "
                         "waste, printed after the run)")
    ap.add_argument("--telemetry", action="store_true",
                    help="install the runtime observability/retuning loop "
                         "and print its metrics after the run")
    ap.add_argument("--telemetry-json", metavar="PATH", default=None,
                    help="with --telemetry: write the JSON snapshot here "
                         "instead of printing Prometheus text")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record structured spans for the whole run and "
                         "write a Chrome trace-event JSON here (open in "
                         "ui.perfetto.dev)")
    ap.add_argument("--ledger", metavar="PATH", default=None,
                    help="append the JSONL flight ledger (choices, probes, "
                         "drift, refits) here; implies --telemetry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    ledger = tracer = None
    if args.ledger:
        from ..trace import Ledger
        ledger = Ledger(args.ledger)
    if args.trace:
        from ..trace import Tracer
        # the tracer shares the ledger: spans persist beside the decisions
        tracer = Tracer(ledger=ledger)
    auto = []
    if args.auto_kernels:
        from ..core.device_model import CudaEventTimer, HopperModel

        tune = (HopperModel() if torch.device(args.device).type == "cpu"
                else CudaEventTimer(device=args.device))
        auto = build_auto_kernels(d_model=cfg.d_model, tune_device=tune,
                                  device=args.device)
        for ak in auto:
            cap = ak.capture
            print(f"auto kernel {ak.name}: "
                  f"{len(ak.spec.operands)} operands, "
                  f"grid rank {len(ak.spec.grid)}, "
                  f"constraints {list(ak.spec.constraints)}, "
                  f"kernel hash {ak.spec.source_fingerprint}, "
                  f"registers {cap.num_regs} ({cap.attributes_source}; "
                  f"launch-bounds cap {cap.regs_cap})", flush=True)
    telemetry = None
    if args.telemetry or ledger is not None:
        telemetry = build_telemetry(
            auto_kernels=auto, ledger=ledger, device=args.device,
            specs=model_kernel_specs(cfg, args.batch, args.max_seq))
    envelope = (default_plan_envelope(args.batch, args.max_seq)
                if args.plans else None)
    buckets = (default_bucket_lattices(cfg, args.batch, args.max_seq)
               if args.buckets else None)
    engine = build_engine(cfg, args.batch, args.max_seq, device=args.device,
                          plan_envelope=envelope, auto_kernels=auto,
                          step_plans=not args.no_step_plans,
                          prefill_chunk=args.prefill_chunk,
                          bucket_lattices=buckets, trace=tracer,
                          telemetry=telemetry)
    ws = engine.warm_started
    print(f"warm start: {len(ws)} driver(s) loaded {list(ws)}, "
          f"{len(ws.plans_loaded)} plan(s), "
          f"{ws.skipped_no_entry} without artifacts, "
          f"{ws.skipped_bad} unloadable")
    if args.plans:
        ps = engine.plan_summary
        print(f"launch plans: {len(ps['compiled'])} compiled, "
              f"{len(ps['loaded'])} loaded from cache, "
              f"{len(ps['skipped'])} skipped (no driver), "
              f"{ps['entries']} plan entries")
    if engine._step_plan is not None:
        sp = engine._step_plan.describe()
        print(f"step plan: {sp['entries']} kernel configs frozen at "
              f"generation {sp['generation']} ({sp['sources']})")
    for i in range(args.requests):
        prompt = [2 + (i * 7 + j) % (cfg.vocab_size - 3)
                  for j in range(4 + i % 4)]
        engine.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new))
    finished = engine.run_async() if args.run_async else engine.run()
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={r.prompt} -> output={r.output}")
    if args.run_async:
        cc = engine.compile_counts
        print(f"async front-end: {cc['decode_step']} decode-step compile(s), "
              f"{cc['prefill_chunk']} prefill-chunk compile(s), "
              f"chunk={engine.prefill_chunk}")
    if args.buckets:
        bs = engine.bucket_stats
        n = bs["hits"] + bs["misses"]
        frac = bs["waste_sum"] / n if n else 0.0
        print(f"bucket dispatch: {bs['hits']} hits, {bs['misses']} misses "
              f"over {bs['steps']} steps, mean padding waste {frac:.3f}")
    if telemetry is not None:
        if args.telemetry_json:
            with open(args.telemetry_json, "w") as f:
                f.write(telemetry.exporter.json())
            print(f"telemetry snapshot written to {args.telemetry_json}")
        elif args.telemetry:
            print(telemetry.prometheus(), end="")
        telemetry.uninstall()
    if tracer is not None:
        n = tracer.write_chrome_trace(args.trace)
        tracer.uninstall()
        print(f"trace: {n} spans written to {args.trace} "
              f"(open in ui.perfetto.dev)")
    if ledger is not None:
        ledger.close()
        print(f"flight ledger: {ledger.n_written} events appended to "
              f"{args.ledger}; render with "
              f"python -m repro_torch.launch.status --ledger {args.ledger}")
        print(f"  (feed drift events to the tuning farm with "
              f"python -m repro_torch.launch.fleet retune --ledger "
              f"{args.ledger})")
    return finished


if __name__ == "__main__":
    main()
