"""Paper Fig. 3: system time -- the cumulative time to reach a launch
decision for every data size 32 <= N <= 2048.

Modeled, as the reference computes it for every row: KLARAPTOR's column is
the probes' device seconds, plus RUN_OVERHEAD_S per probe, plus the build's
wall seconds (probe, fit and code generation); the exhaustive column is
MEASURE_REPS passes of every feasible configuration at every size, each run
paying RUN_OVERHEAD_S.  Measured, for the rows the card times: the build's
wall seconds (built anew, never read from the driver cache) and the wall
seconds of the exhaustive passes themselves.  A size with no feasible
configuration (the f32 matmul at N 32, where bm * bn / 64 threads stay under
one warp) is skipped, and the output says so.  Rows timed as one kernel (on
the card, gemm and corr as ``matmul_b32``) share one build and one
exhaustive pass, and print the same seconds::

    python -m repro_torch.benchmarks.fig3_system_time [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..core import exhaustive_search
from .common import build_suite_drivers, device_arg, timed

SIZES = tuple(2 ** k for k in range(5, 12))   # 32 .. 2048
KERNELS = ("gemm", "atax_k1", "bicg_k1", "mvt_k1", "conv2d", "corr",
           "gesummv", "reduce", "gramschmidt_k1", "syrk")

# Per-run wall overhead (launch, synchronisation, timing harness) and the
# repetitions a trustworthy measurement needs: the reference's model.
RUN_OVERHEAD_S = 2e-3
MEASURE_REPS = 3


def run(kernels=KERNELS, device="cuda") -> list[dict]:
    hw, drivers = build_suite_drivers(kernels, device=device, cache=False)
    rows, memo = [], {}
    for name, row in drivers.items():
        if row.spec.name in memo:       # timed as a kernel already measured
            rows.append({**memo[row.spec.name], "kernel": name})
            continue
        spec, build = row.spec, row.build
        klara_s = (build.probe_device_seconds
                   + build.collected.n_probe_executions * RUN_OVERHEAD_S
                   + build.build_wall_seconds)
        exhaustive_s = exhaustive_wall_s = 0.0
        skipped = []
        for n in SIZES:
            D = dict(zip(spec.data_params, (n,) * len(spec.data_params)))
            t0 = time.perf_counter()
            try:
                _, _, n_cfg, total = exhaustive_search(spec, row.oracle, D,
                                                       hw)
            except ValueError:
                skipped.append(n)
                continue
            exhaustive_wall_s += time.perf_counter() - t0
            exhaustive_s += MEASURE_REPS * (total + n_cfg * RUN_OVERHEAD_S)
        r = {"kernel": name, "oracle": row.oracle_name,
             "klaraptor_s": klara_s, "exhaustive_s": exhaustive_s,
             "speedup": exhaustive_s / max(klara_s, 1e-12),
             "skipped_sizes": skipped}
        if row.oracle_name == "CudaEventTimer":
            r.update(measured_build_s=build.build_wall_seconds,
                     measured_exhaustive_s=exhaustive_wall_s,
                     measured_speedup=exhaustive_wall_s
                     / max(build.build_wall_seconds, 1e-12))
        memo[spec.name] = r
        rows.append(r)
    return rows


def main(argv=None) -> list[str]:
    device = device_arg(argv,
                        "python -m repro_torch.benchmarks.fig3_system_time")
    rows, dt = timed(run, device=device)
    lines = []
    for r in rows:
        line = (f"fig3/{r['kernel']},{dt / len(rows) * 1e6:.0f},"
                f"klaraptor={r['klaraptor_s']:.3f}s "
                f"exhaustive={r['exhaustive_s']:.3f}s "
                f"speedup={r['speedup']:.1f}x (modeled) oracle={r['oracle']}")
        if "measured_speedup" in r:
            line += (f" measured: build={r['measured_build_s']:.3f}s "
                     f"exhaustive={r['measured_exhaustive_s']:.3f}s "
                     f"speedup={r['measured_speedup']:.1f}x")
        if r["skipped_sizes"]:
            line += (f" skipped N={r['skipped_sizes']} (no feasible "
                     f"configuration)")
        lines.append(line)
    med = float(np.median([r["speedup"] for r in rows]))
    lines.append(f"fig3/summary,{dt * 1e6:.0f},median_speedup={med:.1f}x "
                 f"(modeled)")
    return lines


if __name__ == "__main__":
    for ln in main():
        print(ln)
