"""The grouped matmul's bf16 backward on the card, dX and dW apart::

    python src/repro_torch/benchmarks/gmm_backward.py [--src DIR] [--sweep]
    python src/repro_torch/benchmarks/gmm_backward.py --parent DIR
    (either with --json PATH)

Run it as a file, not with ``-m``: ``--src`` decides which ``repro_torch``
it imports.  At qwen3-moe-235b-a22b's and grok-1-314b's MoE layers in
training (B 8 x S 256: each expert's capacity rows, padded as
``ops.moe_gmm`` pads them; the gate / up product d -> d_ff and the down
product d_ff -> d), on inputs made from a seed, it times:

* the whole backward call (CUDA events over back-to-back calls, the median
  of three loops), at the launch parameters ``ops.moe_gmm`` trains at
  (read from ``BACKWARD_LAUNCHES.tiles`` after one call through its
  autograd Function);
* dX's and dW's device time within that call, from a ``torch.profiler``
  trace of ``PROFILE_CALLS`` calls: each kernel goes to the product its
  template's last argument names (1 dX, 2 dW), in both this tree's body and
  the one before it;
* where the tree can launch one product alone (``products=``), each alone
  with CUDA events;
* ``torch.bmm`` for each product and for both, and each one's bound (the
  bytes it must move over 3.35 TB/s, or its FLOPs over 989 TFLOP/s);
* the layer's forward product through ``ops.moe_gmm`` (grad off), which
  the backward's redesign must leave as it was;
* with ``--sweep`` (this tree only), each product alone at every compiled
  (bm, bn) of the backward body that divides it, walked m and n tiles
  fastest, one CTA an SM.

``--src DIR`` imports ``repro_torch`` from DIR (another checkout's
``src``) and times its kernel with the same harness.  ``--parent DIR``
times DIR's tree and this one in turns, parent, this, this, parent, each in
a process of its own, and prints each shape's times side by side.  The last
line is one JSON object.  Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

PEAK_BF16 = 989e12     # H100 SXM dense tensor-core rate
HBM_BW = 3.35e12       # H100 SXM HBM3
TRAIN_B, TRAIN_S = 8, 256
ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b")
PROFILE_CALLS = 5
HERE = Path(__file__).resolve()


def bound_ms(e: int, g: int, k: int, n: int, product: str) -> float:
    """Least time of one product (or of "both") on the card: its inputs
    read once, its output written once, and 2 e g k n FLOPs a product."""
    elems = {"dx": e * (g * n + k * n + g * k),     # dy, w -> dx
             "dw": e * (g * k + g * n + k * n),     # x, dy -> dw
             "both": e * (2 * g * k + 2 * k * n + g * n)}[product]
    flops = 2.0 * e * g * k * n * (2 if product == "both" else 1)
    return max(flops / PEAK_BF16, 2 * elems / HBM_BW) * 1e3


def time_ms(fn, target_ms: float = 60.0, max_iters: int = 20) -> float:
    """Mean ms of fn() from CUDA events over back-to-back calls, after one
    warm-up call; the median of three such loops."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(min(max(target_ms / max(start.elapsed_time(end), 1e-3), 1),
                    max_iters))
    loops = []
    for _ in range(3):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        loops.append(start.elapsed_time(end) / iters)
    return sorted(loops)[1]


def product_split(fn, calls: int = PROFILE_CALLS) -> dict[str, float]:
    """Device ms per call of each product's kernels in ``calls`` calls of
    fn, by the last template argument of the kernel's name (1 dX, 2 dW);
    kernels without one go to "other"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"dx": 0.0, "dw": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        m = re.search(r"<([^<>]*)>\(", ev.key)
        last = m.group(1).split(",")[-1].strip() if m else ""
        key = {"1": "dx", "2": "dw"}.get(last, "other")
        out[key] += getattr(ev, "self_device_time_total", 0.0) / 1e3 / calls
    return out


def shapes():
    """(arch, product name, e, g, k, n) of the two layers' products."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        G, _, C = L.moe_groups(cfg, TRAIN_B * TRAIN_S)
        e, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        g = ops.gemm_dims("moe_gmm_b16", {"e": e, "g": G * C, "k": d,
                                          "n": ff})["g"]
        out += [(arch, "gate_up", e, g, d, ff), (arch, "down", e, g, ff, d)]
    return out


def measure(src: str | None, sweep: bool = False) -> list[dict]:
    """Every shape's times for the tree whose ``src`` is given (this one's
    when None); with ``sweep`` each product at every tile too."""
    sys.path.insert(0, str(Path(src).resolve() if src
                           else HERE.parents[2]))
    import torch
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops

    assert torch.cuda.is_available(), "gmm_backward needs a card"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alone = "products" in inspect.signature(
        gmm.moe_gmm_backward_kernel).parameters
    rows = []
    for arch, name, e, g, k, n in shapes():
        x = torch.randn(e, g, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(e, k, n, generator=gen, device=dev) * k ** -0.5
             ).bfloat16()
        dy = torch.randn(e, g, n, generator=gen, device=dev).bfloat16()
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.grad(ops.moe_gmm(xl, wl), (xl, wl), dy)
        del xl, wl
        tiles = gmm.BACKWARD_LAUNCHES.tiles[(e, g, k, n)]
        keys = gmm.BACKWARD_KEYS if alone else ("bg", "bn", "bk")
        kw = {p + "_tiles": dict(zip(keys, tiles[p])) for p in ("dx", "dw")}

        def call():
            return gmm.moe_gmm_backward_kernel(x, w, dy, **kw)

        row = {"arch": arch, "shape": name, "e": e, "g": g, "k": k, "n": n,
               "tiles": {p: list(tiles[p]) for p in ("dx", "dw")},
               "ms": time_ms(call),
               "fwd_ms": time_ms(lambda: ops.moe_gmm(x, w))}
        split = product_split(call)
        row.update({f"{p}_profiled_ms": split[p] for p in split})
        if alone:
            for p in ("dx", "dw"):
                row[f"{p}_ms"] = time_ms(
                    lambda p=p: gmm.moe_gmm_backward_kernel(
                        x, w, dy, products=(p,), **kw))
        if sweep:
            row["sweep"] = {}
            for p, (m_, n_) in (("dx", (g, k)), ("dw", (k, n))):
                row["sweep"][p] = {
                    f"{bm}x{bn} n_fast {nf}": time_ms(
                        lambda t={"bm": bm, "bn": bn, "n_fast": nf}, p=p:
                        gmm.moe_gmm_backward_kernel(
                            x, w, dy, products=(p,), **{p + "_tiles": t}))
                    for bm, bn in gmm.BACKWARD_SM90_TILES for nf in (0, 1)
                    if m_ % bm == 0 and n_ % bn == 0}
                print(f"    sweep {p}: " + ", ".join(
                    f"{t} {ms:.4f}" for t, ms in row["sweep"][p].items()),
                    flush=True)
        wt = w.transpose(1, 2)
        xt = x.transpose(1, 2)
        row["bmm_dx_ms"] = time_ms(lambda: torch.bmm(dy, wt))
        row["bmm_dw_ms"] = time_ms(lambda: torch.bmm(xt, dy))
        row["bmm_ms"] = time_ms(lambda: (torch.bmm(dy, wt),
                                         torch.bmm(xt, dy)))
        for p in ("dx", "dw", "both"):
            row[f"bound_{p}_ms"] = bound_ms(e, g, k, n, p)
        rows.append(row)
        print(f"  {arch} {name} (e {e}, g {g}, {k} -> {n}) tiles "
              f"{row['tiles']}: call {row['ms']:.4f} ms (profiled dx "
              f"{split['dx']:.4f} dw {split['dw']:.4f} other "
              f"{split['other']:.4f})"
              + (f", alone dx {row['dx_ms']:.4f} dw {row['dw_ms']:.4f}"
                 if alone else "")
              + f" | torch.bmm dx {row['bmm_dx_ms']:.4f} dw "
              f"{row['bmm_dw_ms']:.4f} both {row['bmm_ms']:.4f} | forward "
              f"{row['fwd_ms']:.4f} | bound dx "
              f"{row['bound_dx_ms']:.4f} dw {row['bound_dw_ms']:.4f} both "
              f"{row['bound_both_ms']:.4f}", flush=True)
        del x, w, dy, wt, xt
        torch.cuda.empty_cache()
    return rows


def in_turns(parent: str) -> dict:
    """parent, this, this, parent, each in a process of its own: every
    shape's call time per run, and the product split of each run."""
    runs = []
    for label, src in (("parent", parent), ("this", None), ("this", None),
                       ("parent", parent)):
        cmd = [sys.executable, str(HERE)] + (["--src", src] if src else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{label} run failed:\n{proc.stdout[-4000:]}"
                               f"\n{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])
                     ["rows"]))
        print(f"[{label}]\n" + "\n".join(
            ln for ln in proc.stdout.splitlines() if ln.startswith("  ")),
            flush=True)
    by = {label: [rs for lab, rs in runs if lab == label]
          for label in ("parent", "this")}
    table = []
    for i, row in enumerate(by["this"][0]):
        parent, this = ([rs[i] for rs in by[lab]] for lab in by)
        entry = {"arch": row["arch"], "shape": row["shape"],
                 "parent_ms": [r["ms"] for r in parent],
                 "this_ms": [r["ms"] for r in this],
                 "parent_fwd_ms": [r["fwd_ms"] for r in parent],
                 "this_fwd_ms": [r["fwd_ms"] for r in this],
                 "bmm_ms": [r["bmm_ms"] for r in parent + this],
                 "bound_ms": row["bound_both_ms"]}
        for lab, rs in (("parent", parent), ("this", this)):
            entry[f"{lab}_split"] = [{p: r[f"{p}_profiled_ms"]
                                      for p in ("dx", "dw")} for r in rs]
        entry["speedup"] = min(entry["parent_ms"]) / min(entry["this_ms"])
        table.append(entry)
        print(f"  {row['arch']} {row['shape']}: parent {entry['parent_ms']} "
              f"ms, this {entry['this_ms']} ms ({entry['speedup']:.2f}x); "
              f"torch.bmm x2 {entry['bmm_ms']}; bound "
              f"{entry['bound_ms']:.4f} ms; the forward: parent "
              f"{entry['parent_fwd_ms']}, this {entry['this_fwd_ms']} ms",
              flush=True)
    return {"in_turns": table, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="time the repro_torch under this src")
    ap.add_argument("--parent", help="time this src and the tree's in turns")
    ap.add_argument("--sweep", action="store_true",
                    help="each product at every compiled tile too")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    out = in_turns(args.parent) if args.parent else \
        {"rows": measure(args.src, args.sweep)}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
