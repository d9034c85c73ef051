#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (src/repro_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives KLARAPTOR's tune -> choose -> launch loop on the card for both of
the port's CUDA kernels, and serves llama3.2-1b (16 layers, d_model 2048,
32 q and 8 kv heads of dim 64, d_ff 8192, vocab 128256, bf16, seeded random
weights) through the port's prefill step and serving engine, one phase per
printed block:

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
     (printed, not gated);
  7. the flash-attention kernel against its plain version, bf16 and f32,
     causal and not, GQA group 4 and 1, window 64, softcap 30, head dims
     64 / 128 / 256, at a ragged length, over every feasible (bq, bkv);
  8. KLARAPTOR on the card for ``flash_attn_d64_causal``: probes at
     bh <= 64 and sq = skv <= 1024, the fit, the choice at the prefill shape
     (bh 32, sq = skv = 4096) and, after phase 9, its selection ratio against
     exhaustive search (printed, not gated);
  9. the prefill step of llama3.2-1b at full width on 4096 tokens (cut from
     the ``prefill_32k`` preset's 32 x 32768 to fit the time limit): the
     tuned flash kernel launches once per layer, the logits are held against
     the same step with the plain attention, and each layer's attention is
     timed (kernel, bound, SDPA yardstick, plain);
 10. the serving engine at full width: 4 slots, 8 requests, every request
     finishes, and each greedy request's first token is compared with the
     argmax of the prefill step on its prompt.

The two kernels' main paths are phases 4-5 (matmul) and 8-9 (flash
attention): each launch counter is set to 0 just before its path and read
just after it; launches made to compare a kernel with its plain version or
to time it come after the read.
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


def _device_profile(fn, what: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print the device time
    by kernel group (flash, GEMM, the rest) and the device-busy share of
    the window's wall time (inflated by the profiler's own overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        name = ev.key.lower()
        group = "flash" if "flash_fwd" in name else "gemm" if any(
            t in name for t in ("gemm", "cutlass", "xmma", "cublas",
                                "nvjet")) else "other"
        groups[group] += ms
        kernels.append((ms, ev.count, ev.key))
    busy = sum(groups.values())
    if busy <= 0.0:
        print(f"  profile of {what}: the profiler saw no device time; "
              f"device time not measured")
        return {}
    print(f"  profile of {what} (torch.profiler): wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms ({busy / wall_ms:.1%}); "
          + ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})"
                      for g, ms in groups.items()), flush=True)
    for ms, count, name in sorted(kernels, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **groups}


def _flash_bound_ms(bh: int, sq: int, skv: int, hkv_rows: int, d: int,
                    causal: bool, elem: int) -> tuple[float, str]:
    """Least time of one flash-attention call on the card: q, k, v read
    once and the output written once, and 4 d FLOPs per visible (query,
    key) pair (causal: the pairs on and below the diagonal) at the
    tensor-core peak of bf16 inputs."""
    if causal:
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    t_ops = 4.0 * d * bh * pairs / PEAK_BF16
    t_bytes = (2 * bh * sq + 2 * hkv_rows * skv) * d * elem / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
    from repro_torch.core.kernel_spec import (FLASH_HEAD_DIMS,
                                              MATMUL_REGS_PER_THREAD,
                                              flash_regs_per_thread)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as flash
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

    def phase_done(n: int) -> None:
        now = time.perf_counter()
        print(f"  (phase {n}: {now - clock[0]:.2f} s wall)", flush=True)
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
    flash_ptxas = [ln.strip() for ln in
                   _build.build_log("flash_attention").splitlines()
                   if "registers" in ln or "spill" in ln]
    print("  flash_attention ptxas:\n  " + "\n  ".join(flash_ptxas))
    for dt in (torch.bfloat16, torch.float32):
        for d in FLASH_HEAD_DIMS:
            for bkv in flash.BKV_TILES:
                attrs = flash.kernel_attributes(dt, d, bkv)
                print(f"  flash {dt} d={d} bkv={bkv}: {attrs}")
                if attrs["num_regs"] > flash_regs_per_thread(d):
                    raise AssertionError(
                        f"flash kernel d={d} bkv={bkv} uses "
                        f"{attrs['num_regs']} registers; the spec assumes "
                        f"{flash_regs_per_thread(d)}")
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
                                      "ms", "default_ms", "library_ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows],
    }
    flash_row = flash_phases(dev, hw, gen, check, time_ms, phase_done)
    print(json.dumps({"kernels": [matmul_row, flash_row], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def flash_phases(dev, hw, gen, check, time_ms, phase_done) -> dict:
    """Phases 7-10: the flash-attention kernel, KLARAPTOR on it, the
    llama3.2-1b prefill step and the serving engine.  Returns the kernel's
    entry of the ``kernels`` line."""
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
          f"S = {FLASH_SWEEP_S}, batch 2)", flush=True)
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
                    print(f"  {dtype} d={d} hq/hkv={hq}/{hkv} {name}: "
                          f"{len(errs)} tiles, max_abs_err={max(errs):.3e} "
                          f"ok", flush=True)
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
    print(f"  prefill wall {(time.perf_counter() - t0) * 1e3:.2f} ms "
          f"(second call)")
    _device_profile(lambda: step(params, tokens), "one prefill step")

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
        layers.append(r)
        print(f"  layer {li:2d}: kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s) | default "
              f"{r['default_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
              f"({bound_by}) | SDPA {r['library_ms']:.4f} ms | plain "
              f"{r['plain_ms']:.2f} ms | max_abs_err {err:.3e}", flush=True)
    del recorded, ref_logits
    torch.cuda.empty_cache()

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
          f"decode step", flush=True)
    if sorted(r.rid for r in done) != list(range(N_REQUESTS)) \
            or not all(r.done and 1 <= len(r.output) <= MAX_NEW
                       for r in done):
        raise AssertionError("not every request finished")
    tok = torch.tensor(engine.slot_last, device=dev)
    pos = torch.tensor(np.arange(ENGINE_SLOTS) + 64, device=dev,
                       dtype=torch.int32)

    def four_decode_steps():
        for _ in range(4):
            engine.model.decode_step(params, tok, pos, engine.cache)

    _device_profile(four_decode_steps, f"4 decode steps at batch "
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

    total = {key: sum(r[key] for r in layers)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                         "default_ms")}
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
        "config": chosen,
        "selection_ratio": ratio["ratio"],
        "layers": layers,
    }

if __name__ == "__main__":
    sys.exit(main())
