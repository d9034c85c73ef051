"""The serving engine's chunk-graph captures on the main thread and on a
second thread, with the CPU time each takes::

    python -m repro_torch.benchmarks.graph_capture [--one-arena]

A fresh llama3.2-1b engine (full width, seeded random weights, batch 4,
max_seq 96, ``prefill_chunk`` 32) prefills one 64-token prompt in chunks of
32, 16, 8, 4, 2 and 1: each chunk size runs eagerly once and is captured.
That is done on the main thread, then with another fresh engine on a plain
thread that the main thread joins (the async front-end's scheduler thread
is such a thread).  Each capture prints its wall seconds, the part of them
spent recording (the rest ends the capture and instantiates the graph),
and the capturing thread's user and system CPU seconds; the last line is
one JSON object with the same numbers.  ``--one-arena`` first calls glibc's
``mallopt(M_ARENA_MAX, 1)``, so the second thread allocates from the main
thread's malloc arena instead of an arena of its own.  Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import resource
import sys
import threading
import time

import torch

M_ARENA_MAX = -8            # glibc's mallopt parameter
PROMPT_LEN = 64


def _engine(cfg, params):
    from ..launch import build_engine

    return build_engine(cfg, batch=4, max_seq=96, params=params,
                        prefill_chunk=32)


def _captures(engine, prompt) -> list[dict]:
    """Prefill ``prompt`` into slot 0 in chunks on the calling thread;
    each capture's numbers, in the order they were taken."""
    from ..serving import graphs

    rows = []
    capture = graphs.StepGraph._capture

    def measured(step):
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        capture(step)
        r1 = resource.getrusage(resource.RUSAGE_THREAD)
        rows.append({"capture_s": step.capture_s, "record_s": step.record_s,
                     "user_s": r1.ru_utime - r0.ru_utime,
                     "sys_s": r1.ru_stime - r0.ru_stime})

    graphs.StepGraph._capture = measured
    try:
        engine._prefill_chunked(0, prompt)
        torch.cuda.synchronize()
    finally:
        graphs.StepGraph._capture = capture
    for c, row in zip(engine._pow2_chunks(len(prompt) - 1, 32), rows):
        row["chunk"] = c
    return rows


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    one_arena = "--one-arena" in argv
    if one_arena:
        ctypes.CDLL("libc.so.6").mallopt(M_ARENA_MAX, 1)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    from ..configs import get_config
    from ..models import Model

    cfg = get_config("llama3.2-1b")
    params = Model(cfg).init(0)
    prompt = [2 + (7 * 1000 + j) % (cfg.vocab_size - 4)
              for j in range(PROMPT_LEN)]
    out = {"one_arena": one_arena,
           "card": torch.cuda.get_device_name(0)}
    out["main"] = _captures(_engine(cfg, params), prompt)
    engine, box = _engine(cfg, params), {}
    th = threading.Thread(
        target=lambda: box.update(rows=_captures(engine, prompt)),
        name="second")
    t0 = time.perf_counter()
    th.start()
    th.join()
    if "rows" not in box:
        raise RuntimeError("the capture on the second thread failed")
    out["second"] = box["rows"]
    out["second_wall_s"] = time.perf_counter() - t0
    for where in ("main", "second"):
        for r in out[where]:
            print(f"{where} thread, chunk {r['chunk']:2d}: capture "
                  f"{r['capture_s']:.3f} s (recording {r['record_s']:.3f} "
                  f"s), user {r['user_s']:.3f} s, sys {r['sys_s']:.3f} s",
                  flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
