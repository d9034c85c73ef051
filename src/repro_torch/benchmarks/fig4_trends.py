"""Paper Fig. 4: predicted against actual execution-time trends.

For three kernels (the paper shows atax, corr and gramschmidt) sweep N and
check that (a) the driver's predicted times over the candidate table
correlate with the oracle's (log-log), and (b) the configuration the
prediction ranks first is near the actual minimum ("predicted minima occur
at actual minima")::

    python -m repro_torch.benchmarks.fig4_trends [--device cpu]
"""

from __future__ import annotations

import numpy as np

from .common import build_suite_drivers, device_arg, timed

KERNELS = ("atax_k1", "corr", "gramschmidt_k1")
SIZES = (512, 1024, 2048, 4096)


def run(kernels=KERNELS, device="cuda") -> list[dict]:
    hw, drivers = build_suite_drivers(kernels, device=device)
    rows, memo = [], {}
    for name, row in drivers.items():
        if row.spec.name in memo:       # timed as a kernel already swept
            rows.append({**memo[row.spec.name], "kernel": name})
            continue
        spec = row.spec
        corr_per_size = []
        min_align = []
        for n in SIZES:
            D = dict(zip(spec.data_params, (n,) * len(spec.data_params)))
            table = spec.candidates(D, hw)
            pred = row.build.driver.estimate_batch(D, table.columns)
            actual = row.oracle.true_time_batch(
                spec.traffic_table(D, table, hw))
            if len(table) >= 3:
                corr_per_size.append(float(np.corrcoef(
                    np.log(pred), np.log(actual))[0, 1]))
            min_align.append(actual[int(np.argmin(pred))] / actual.min())
        memo[spec.name] = {
            "kernel": name,
            "oracle": row.oracle_name,
            "log_corr": float(np.mean(corr_per_size)),
            "min_alignment": float(np.median(min_align)),
        }
        rows.append(memo[spec.name])
    return rows


def main(argv=None) -> list[str]:
    device = device_arg(argv, "python -m repro_torch.benchmarks.fig4_trends")
    rows, dt = timed(run, device=device)
    return [f"fig4/{r['kernel']},{dt / len(rows) * 1e6:.0f},"
            f"log_corr={r['log_corr']:.3f} "
            f"argmin_actual/min_actual={r['min_alignment']:.3f} "
            f"oracle={r['oracle']}" for r in rows]


if __name__ == "__main__":
    for ln in main():
        print(ln)
