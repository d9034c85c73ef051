#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (src/repro_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives KLARAPTOR's tune -> choose -> launch loop on the card for each of
the port's six CUDA kernels, serves llama3.2-1b (16 layers, d_model 2048,
32 q and 8 kv heads of dim 64, d_ff 8192, vocab 128256, bf16, seeded random
weights) and mamba2-130m through the port's prefill step and serving engine,
and derives kernel specs from the compiled kernels, one phase per printed
block:

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
     (bf16 at d 64 and 128) and every feasible SIMT tile (f32, bf16 at d
     256);
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
     against ``torch.bmm`` in f32 (TF32 off) and the FP32 bound;
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
     flash launch's card time from phase 9 (printed, not gated).

The kernels' main paths are phases 4-5 (matmul), 8-9 (flash attention),
12-13 (SSD scan), 16 (grouped matmul, bf16, then f32), 18 (layernorm and
column sum; 19 is the entry point, read the same way), 20 (b) (the f32
SIMT matmul: the suite's probes and exhaustive passes) and 21 (the bf16
matmul, flash attention and the SSD under launch and step plans): each
launch counter is set to 0
just before its path and read just after it; launches made to compare a
kernel with its plain version or to time it come after the read.  The
driver cache (``$KLARAPTOR_CACHE_DIR``) is an empty temporary directory
for the whole run, so every phase probes on the card and no run reads an
earlier run's drivers.
The line before the last is one JSON object with each kernel's numbers; the
last is ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits nonzero.  Without a CUDA device, or outside a checkout, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# Phase 18: llama3.2-1b's d_model and the reference's auto-kernel shapes
# (benchmarks/bench_introspect.py), plus a row count no multiple of 8
# divides (the layernorm's masked last row block).
AUTO_D_MODEL = 2048
LN_ROWS = (4096, 16384, 4097)
COLSUM_SHAPES = ((8192, 4096), (2048, 8192))


def _device_profile(fn, what: str, own: tuple = ("flash", "flash_")
                    ) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print the device time
    by kernel group (the port's kernel ``own`` = (group, name fragment),
    GEMM, the rest) and the device-busy share of the window's wall time
    (inflated by the profiler's own overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {own[0]: 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        name = ev.key.lower()
        group = own[0] if own[1] in name else "gemm" if any(
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
    for lib in libs:
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True, check=True)
        hgmma = sum("HGMMA" in ln for ln in sass.stdout.splitlines())
        print(f"  {lib.name}: {hgmma} HGMMA instructions in the SASS")
        if hgmma == 0 and lib.name.startswith(("libmatmul-", "libmoe_gmm-",
                                               "libflash_attention-",
                                               "libssd_scan-")):
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
                   if "registers" in ln or "spill" in ln]
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
    for dt, d in [(torch.float32, d) for d in FLASH_HEAD_DIMS] \
            + [(torch.bfloat16, 256)]:
        for bkv in flash.BKV_TILES:
            attrs = flash.kernel_attributes(dt, d, bkv)
            print(f"  flash SIMT {dt} d={d} bkv={bkv}: {attrs}")
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
    gmm32_row, gmm_row = gmm_phases(dev, hw, gen, check, time_ms,
                                    phase_done)
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
    print(json.dumps({"kernels": [matmul_row, flash_row, ssd_row, gmm_row,
                                  ln_row, cs_row, simt_row, gmm32_row],
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
          "d 64 and 128) and every feasible SIMT tile (f32, and bf16 at d "
          "256)", flush=True)
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
                    own=("ssd", "ssd_"))

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
                    f"{ENGINE_SLOTS}", own=("ssd", "ssd_"))
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
               phase_done) -> tuple[dict, dict]:
    """Phases 15-16: the grouped-matmul kernel and KLARAPTOR on it, bf16
    and f32.  Returns the f32 and the bf16 entries of the ``kernels``
    line."""
    import torch

    from repro_torch.core import (CudaEventTimer, Klaraptor, gmm_probe_data,
                                  moe_gmm_spec, selection_ratio)
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
    }


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


if __name__ == "__main__":
    sys.exit(main())
