"""Run the paper's evaluation on the port: Fig. 1, Table I, Fig. 3 and
Fig. 4, in that order, each printing ``name,us_per_call,derived`` lines::

    python -m repro_torch.benchmarks.run [--device cpu]
"""

from __future__ import annotations


def main(argv=None) -> None:
    from . import fig1_accuracy, fig3_system_time, fig4_trends, table1_configs
    from .common import device_arg

    device = device_arg(argv, "python -m repro_torch.benchmarks.run")
    for mod in (fig1_accuracy, table1_configs, fig3_system_time,
                fig4_trends):
        for line in mod.main(["--device", device]):
            print(line, flush=True)


if __name__ == "__main__":
    main()
