#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (src/repro_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives KLARAPTOR's tune -> choose -> launch loop on the card at the GEMM
shapes of llama3.2-1b (d_model 2048, 8 kv heads of dim 64, d_ff 8192,
vocab 128256) at 4096 tokens, one phase per printed block:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc compiles every CUDA source of the port (timed);
  3. the kernel against its plain PyTorch version on the card, in bf16 and
     f32, over a sweep of the spec's candidate tiles and at the five GEMM
     shapes;
  4. KLARAPTOR on the card: probes of the real kernel (CUDA events) at
     m, n, k <= 1024, the SVD fit and the generated driver;
  5. the tuned launch through ``ops.matmul`` at the five shapes, with kernel,
     bound, ``torch.matmul`` (yardstick only), default-config and plain
     times, and the launch counter;
  6. the selection ratio against exhaustive search at three shapes
     (printed, not gated).

The line before the last is one JSON object with each kernel's numbers; the
last is ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits nonzero.  Without a CUDA device, or outside a checkout, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
HBM_BW = 3.35e12       # H100 SXM HBM3
SEED = 0


def _bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """Least time of a bf16 GEMM on the card: each input read once, the
    output written once, and 2mnk FLOPs at the tensor-core peak."""
    t_ops = 2.0 * m * n * k / PEAK_BF16
    t_bytes = (m * k + k * n + m * n) * 2 / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.core import (CudaEventTimer, HardwareParams, Klaraptor,
                                  fit_tile, matmul_spec, registry,
                                  selection_ratio)
    from repro_torch.core.kernel_spec import MATMUL_REGS_PER_THREAD
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.matmul import (LAUNCHES, kernel_attributes,
                                            matmul_kernel, matmul_plain)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def time_ms(fn, target_ms: float = 40.0, max_iters: int = 20) -> float:
        """Mean ms of fn() from CUDA events, after one warm-up launch."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        once = start.elapsed_time(end)
        iters = int(min(max(target_ms / max(once, 1e-3), 1), max_iters))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def check(a, b, dtype, what: str) -> float:
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        torch.cuda.synchronize()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite output")
        ok = torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
        err = max_err(a, b)
        print(f"  {what}: max_abs_err={err:.3e} tol={tol:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: kernel disagrees with plain")
        return err

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

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[2] build: {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.2f} s")
    ptxas = [ln.strip() for ln in _build.build_log("matmul").splitlines()
             if "registers" in ln or "spill" in ln]
    print("  " + "\n  ".join(ptxas))
    for dt in (torch.bfloat16, torch.float32):
        attrs = kernel_attributes(dt)
        print(f"  matmul {dt}: {attrs}")
        if attrs["num_regs"] > MATMUL_REGS_PER_THREAD:
            raise AssertionError(
                f"kernel uses {attrs['num_regs']} registers; the spec "
                f"assumes {MATMUL_REGS_PER_THREAD}")

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
    for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        D = {"m": 512, "n": 1024, "k": 512}
        table = matmul_spec(nbytes).candidates(D, hw)
        x, y = inputs(D["m"], D["n"], D["k"], dtype)
        plain = matmul_plain(x, y)
        picks = sorted(set(range(0, len(table), max(len(table) // 12, 1)))
                       | {len(table) - 1})
        for i in picks:
            P = table.row(i)
            out = matmul_kernel(x, y, **P)
            worst = max(worst, check(out, plain, dtype,
                                     f"{dtype} sweep {D} {P}"))
    kept = {}
    for name, m, n, k in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, y = inputs(m, n, k, dtype)
            plain = matmul_plain(x, y)
            cfg = {p: fit_tile(s, v, 8) for (p, v), s in
                   zip(ops.MATMUL_DEFAULT.items(), (m, n, k))}
            out = matmul_kernel(x, y, **cfg)
            worst = max(worst, check(out, plain, dtype,
                                     f"{dtype} {name} ({m},{n},{k}) {cfg}"))
            del out
            if dtype == torch.bfloat16:
                kept[name] = (x, y, plain)
            del x, y, plain
    x, y, plain = kept["q_o_proj"]
    out = matmul_kernel(x, y, bm=128, bn=128, bk=32, out_dtype=torch.float32)
    worst = max(worst, check(out, plain, torch.bfloat16,
                             "bf16 in, f32 out q_o_proj"))
    del out
    torch.cuda.empty_cache()

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
        dflt = {p: fit_tile(s, v, 8) for (p, v), s in
                zip(ops.MATMUL_DEFAULT.items(), (m, n, k))}
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
        rows.append(r)
        print(f"  {name} ({m},{n},{k}) chosen {cfg} {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s) | default {dflt} "
              f"{r['default_ms']:.4f} ms | torch.matmul "
              f"{r['library_ms']:.4f} ms | plain {r['plain_ms']:.2f} ms | "
              f"bound {r['bound_ms']:.4f} ms ({bound_by})", flush=True)
        del x, y, plain
        torch.cuda.empty_cache()

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

    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    print(json.dumps({"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:46",
        "launches": launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in rows) else "bytes",
        "library_ms": total["library_ms"],
        "shapes": [{k: r[k] for k in ("shape", "m", "n", "k", "config",
                                      "ms", "default_ms", "library_ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows],
    }], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
