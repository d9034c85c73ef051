"""The paper's own evaluation workload: the PolyBench/GPU-analogue kernel
suite (Section VI, Table I) as a selectable "architecture", on Hopper.

This config is not a language model: it names the suite's kernel specs
(``core.kernel_spec.polybench_suite``) and the paper's data sizes, which the
benchmarks in ``repro_torch.benchmarks`` run KLARAPTOR over.
"""

from ..core.kernel_spec import polybench_suite

ARCH_ID = "polybench"

# Table I uses N in {256 .. 8192}; probes use small sizes only (Section III-B).
PROBE_SIZES = (256, 512, 1024)
EVAL_SIZES = (1024, 2048, 4096, 8192)


def suite():
    return polybench_suite()


def eval_points(spec, sizes=EVAL_SIZES):
    """Table-I style evaluation (D assignments) for one suite kernel."""
    out = []
    for n in sizes:
        if set(spec.data_params) == {"m", "n", "k"}:
            out.append({"m": n, "n": n, "k": n})
        elif set(spec.data_params) == {"r", "c"}:
            out.append({"r": n, "c": n})
        else:
            raise ValueError(spec.data_params)
    return out
