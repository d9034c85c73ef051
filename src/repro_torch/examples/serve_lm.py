"""End-to-end serving driver: batched requests through the continuous-
batching engine (more requests than decode slots -> slots are recycled).

The JAX package's ``examples/serve_lm.py``, on the card unless ``--device
cpu``::

    python -m repro_torch.examples.serve_lm --no-smoke --requests 10 --batch 4
    python -m repro_torch.examples.serve_lm --device cpu --requests 10

``--smoke`` (the default, the reference's choice) serves the arch's smoke
config and ``--no-smoke`` its published one.  The smoke llama's head dim
32 has no flash-attention kernel, so on the card it raises the kernel's
``ValueError``: serve it with ``--device cpu`` or take ``--no-smoke``.

``--async`` routes the same workload through the engine's async
front-end: a scheduler thread owns the device loop, ``submit`` is
thread-safe (requests here are submitted *while the engine is already
running*), and prefill advances in chunks of descending powers of two
instead of one step per prompt token.  Greedy outputs are identical to the
synchronous path; the printout adds the compile counts (on the card, the
engine's CUDA-graph captures), which stay at one decode step and at most
log2(prefill_chunk) + 1 prefill chunks however many prompt lengths
arrive.

``--trace out.json`` records the whole run (engine bring-up, prefill,
decode steps, kernel dispatch) as a nested span tree and writes a Chrome
trace-event file to load in ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..launch.serve import build_engine
from ..serving import Request, ServingEngine


def main(argv: list[str] | None = None
         ) -> tuple[list[Request], ServingEngine]:
    """Serve the requests; returns (the finished requests, the engine)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the arch's smoke config (default) or, with "
                         "--no-smoke, its published one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="serve through the async front-end (scheduler "
                         "thread + chunked prefill); requests are "
                         "submitted while the engine is running")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or "
                         "cpu (their plain versions)")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace:
        from ..trace import Tracer
        tracer = Tracer()
    cfg = get_config(args.arch, smoke=args.smoke)
    engine = build_engine(cfg, args.batch, args.max_seq, device=args.device,
                          trace=tracer)
    t0 = time.perf_counter()
    if args.run_async:
        # Submit-while-running: the scheduler thread picks requests up as
        # they arrive, which is the whole point of the async front-end.
        engine.start()
    for i in range(args.requests):
        prompt = [2 + (13 * i + j) % (cfg.vocab_size - 4)
                  for j in range(3 + i % 5)]
        engine.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new,
                              temperature=0.0 if i % 2 == 0 else 0.8))
    if args.run_async:
        finished = engine.drain()
        engine.stop()
    else:
        finished = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in finished)
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"req {r.rid:2d} ({'greedy' if r.temperature == 0 else 'T=.8'})"
              f": {r.prompt} -> {r.output}")
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "CPU")
    print(f"\n{len(finished)} requests, {toks} tokens in {dt:.1f}s through "
          f"{args.batch} continuous-batching slots "
          f"({toks / dt:.1f} tok/s on {where})")
    if args.run_async:
        cc = engine.compile_counts
        print(f"async front-end: {cc['decode_step']} decode-step "
              f"compile(s), {cc['prefill_chunk']} prefill-chunk compile(s) "
              f"across {args.requests} mixed-length prompts "
              f"(chunk={engine.prefill_chunk})")
    if engine._step_plan is not None:
        sp = engine._step_plan.describe()
        print(f"step plan: {sp['entries']} kernel configs frozen at "
              f"registry generation {sp['generation']} "
              f"(sources: {sp['sources']}) -- decode steps dispatch "
              f"from the frozen table, zero registry round-trips")
    from ..core.driver import registry
    print(f"decision-memo hits this run: {registry.memo_hits()}")
    if tracer is not None:
        n = tracer.write_chrome_trace(args.trace)
        tracer.uninstall()
        print(f"trace: {n} spans -> {args.trace} (open in ui.perfetto.dev)")
    return finished, engine


if __name__ == "__main__":
    main()
