"""Host microseconds per launch decision, with and without a tracer::

    python -m repro_torch.benchmarks.decision_overhead [--reps N]

A ``matmul_b16`` driver is built on ``HopperModel`` (host work only: no
card is needed or touched) and registered with a launch plan over a small
envelope; then each way a launch can be decided is timed on the host, as
``chip_smoke.py`` phase 21 (e) times them: the decision memo's hit, the
chain behind it with the memo off (a plan probe), the static default, a
step plan's resolve, and ``kernels.ops``' resolution of a launch that no
step plan covers (its fall-through to ``choose_or_default``).  When
``repro_torch.trace`` exists, the fall-through is timed again under an
installed ``Tracer``, which wraps it in a ``dispatch.choose`` span.  Each
number is the median of five loops of ``--reps`` calls.  The script uses
only entry points that predate tracing, so it also runs against an older
checkout's ``src`` (``PYTHONPATH=<old>/src python <this file>``) and the
two trees can be compared on one machine.  The last line is one JSON
object of the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

D = {"m": 1024, "n": 2048, "k": 512}
ENVELOPE = {"m": [512, 1024, 2048], "n": [1024, 2048], "k": [512, 1024]}
DEFAULT = {"bm": 128, "bn": 128, "bk": 64}


def _us(fn, reps: int) -> float:
    """Median over five loops of the per-call host microseconds."""
    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        loops.append((time.perf_counter() - t0) / reps * 1e6)
    return sorted(loops)[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.decision_overhead",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20000)
    args = ap.parse_args(argv)
    os.environ["KLARAPTOR_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="decision-overhead-")

    import repro_torch
    from repro_torch.core import (HopperModel, Klaraptor, compile_plan,
                                  lattice, matmul_spec, registry)
    from repro_torch.core.driver import (choose_or_default,
                                         set_decision_memo)
    from repro_torch.core.step_plan import KernelRequest, build_step_plan
    from repro_torch.kernels import ops

    build = Klaraptor(HopperModel(noise=0.03, seed=7), device="cpu",
                      cache=False).build_driver(
        matmul_spec(), repeats=2, max_configs_per_size=16)
    kernel = build.driver.kernel
    registry.register_plan(compile_plan(build.driver, lattice(ENVELOPE)))
    sp = build_step_plan([KernelRequest.make(kernel, D, DEFAULT)])
    choose_or_default(kernel, D, DEFAULT)            # memoized
    reps = args.reps

    prev = set_decision_memo(False)
    try:
        behind = _us(lambda: choose_or_default(kernel, D, DEFAULT), reps)
    finally:
        set_decision_memo(prev)
    us = {
        "memo hit": _us(lambda: choose_or_default(kernel, D, DEFAULT), reps),
        "plan decision, memo off": behind,
        "default": _us(lambda: choose_or_default("untuned_kernel", D,
                                                 DEFAULT), reps),
        "step-plan resolve": _us(lambda: sp.resolve(kernel, D), reps),
        "ops fall-through": _us(
            lambda: ops._resolve(kernel, D, DEFAULT, None), reps),
    }
    try:
        from repro_torch.trace import Tracer
    except ImportError:
        Tracer = None
    if Tracer is not None:
        with Tracer(capacity=1024):
            us["ops fall-through, traced"] = _us(
                lambda: ops._resolve(kernel, D, DEFAULT, None), reps)
    if sp.stale():
        raise AssertionError("the step plan went stale while timing")
    out = {"tree": os.path.dirname(os.path.dirname(repro_torch.__file__)),
           "python": sys.version.split()[0], "reps": reps, "host_us": us}
    for name, v in us.items():
        print(f"{name:>28}: {v:.3f} us")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
