"""The paper's evaluation on the port: the PolyBench suite on Hopper, and
the Fig. 1 / Table I / Fig. 3 / Fig. 4 twins on the CPU.

The suite is held to the JAX package's (``repro.core.polybench_suite``):
the same 28 rows with the same data and program parameters, FLOPs,
candidates and fit variables, and the same probe and evaluation sizes.  What
differs does so by design and is tested as such: the reference's
``mxu_fraction`` has no counterpart on the CUDA cores, so corr and covar
equal gemm; the TPU's lane padding and lane / sublane rules give way to the
bytes a CUDA kernel moves and warp granules.  The figures run on
``HopperModel`` (``device="cpu"``); the paper's bar is a median Fig. 1 ratio
of at least 0.85.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import polybench as ref_polybench
from repro.core import polybench_suite as ref_polybench_suite

from repro_torch.benchmarks import (common, fig1_accuracy, fig3_system_time,
                                    fig4_trends, table1_configs)
from repro_torch.configs import polybench
from repro_torch.core import H100, matmul_spec, registry, spec_fingerprint
from repro_torch.core.kernel_spec import (POLYBENCH_LAUNCH_ALIASES,
                                          POLYBENCH_MATMUL_ROWS,
                                          POLYBENCH_SUITE)
from repro_torch.examples import polybench_suite as suite_example
from repro_torch.examples import quickstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = polybench.suite()
REF = ref_polybench_suite()
FAMILIES = {
    "matmul": POLYBENCH_MATMUL_ROWS,
    "matvec": ("atax_k1", "atax_k2", "bicg_k1", "bicg_k2", "mvt_k1",
               "mvt_k2", "gesummv", "gramschmidt_k1", "gramschmidt_k2",
               "gramschmidt_k3"),
    "stencil": ("conv2d", "conv3d", "fdtd_step1", "fdtd_step2",
                "fdtd_step3"),
    "reduction": ("reduce", "mean", "std"),
}


def _family(name: str) -> str:
    return next(f for f, names in FAMILIES.items() if name in names)


def _without_name(spec) -> dict:
    fp = spec_fingerprint(spec)
    fp.pop("name")
    return fp


def test_same_28_rows_in_order():
    assert list(PORT) == list(REF) == list(POLYBENCH_SUITE)
    assert len(PORT) == 28
    assert sorted(PORT) == sorted(n for f in FAMILIES.values() for n in f)


@pytest.mark.parametrize("name", list(REF))
def test_row_parameters_match_reference(name):
    """The reference's parameters, FLOPs, candidates and fit variables; the
    matmul rows take the tiles of the f32 SIMT kernel they launch (the
    reference's are the TPU matmul's), a divergence by design."""
    port, ref = PORT[name], REF[name]
    assert port.name == ref.name == name
    assert port.data_params == ref.data_params
    assert port.program_params == ref.program_params
    assert port.flops_per_point == ref.flops_per_point
    if name in POLYBENCH_MATMUL_ROWS:
        assert port.param_candidates == \
            matmul_spec(dtype_bytes=4).param_candidates
    else:
        assert port.param_candidates == ref.param_candidates
    assert port.fit_vars == ref.fit_vars
    # the grid's points, which the FLOPs count over, are the reference's
    assert [a.data for a in port.grid] == [a.data for a in ref.grid]


def test_sizes_and_eval_points_match_reference():
    assert polybench.ARCH_ID == ref_polybench.ARCH_ID
    assert polybench.PROBE_SIZES == ref_polybench.PROBE_SIZES
    assert polybench.EVAL_SIZES == ref_polybench.EVAL_SIZES
    for name in PORT:
        assert polybench.eval_points(PORT[name]) == \
            ref_polybench.eval_points(REF[name])
        assert polybench.eval_points(PORT[name], sizes=(2048,)) == \
            ref_polybench.eval_points(REF[name], sizes=(2048,))


@pytest.mark.parametrize("name", list(PORT))
def test_candidates_at_1024_obey_hopper_limits(name):
    """The port's twin of ``TestPolybenchSuite``: every row has candidates
    at N 1024 (each family at least 8) within the Hopper launch limits."""
    spec = PORT[name]
    D = polybench.eval_points(spec, sizes=(1024,))[0]
    table = spec.candidates(D, H100)
    assert len(table) >= 8
    tt = spec.traffic_table(D, table, H100)
    assert np.all(tt.threads >= H100.warp_size)
    assert np.all(tt.threads <= H100.max_threads_per_block)
    assert np.all(tt.threads * spec.regs_per_thread <= H100.regs_per_sm)
    assert np.all(tt.stage_bytes <= H100.smem_per_block_optin)
    assert np.all(tt.blocks_per_sm >= 1)
    assert spec.compute_unit == "f32"


def test_matmul_rows_are_the_f32_simt_matmul():
    """Every matmul row is ``matmul_spec(4)`` renamed (syr2k with its two
    products per point); so corr and covar equal gemm, where the reference
    gives them an mxu_fraction of 0.8 (a divergence by design)."""
    simt = _without_name(matmul_spec(dtype_bytes=4))
    for name in POLYBENCH_MATMUL_ROWS:
        fp = _without_name(PORT[name])
        if name == "syr2k":
            assert fp.pop("flops_per_point") == 4.0
            fp["flops_per_point"] = simt["flops_per_point"]
        assert fp == simt, name
    assert _without_name(PORT["corr"]) == _without_name(PORT["gemm"])
    assert _without_name(PORT["covar"]) == _without_name(PORT["gemm"])
    assert REF["corr"].mxu_fraction != REF["gemm"].mxu_fraction


def test_launch_aliases():
    """The nine rows whose spec is the f32 matmul's, FLOPs included, launch
    ``matmul_b32`` on the card, timed as that kernel (the matmul spec under
    its name, so one build serves all nine); syr2k and the other families
    launch nothing and are timed as themselves."""
    assert set(POLYBENCH_LAUNCH_ALIASES) == \
        set(POLYBENCH_MATMUL_ROWS) - {"syr2k"}
    assert set(POLYBENCH_LAUNCH_ALIASES.values()) == {"matmul_b32"}
    for name in PORT:
        expect = "CudaEventTimer" if name in POLYBENCH_LAUNCH_ALIASES \
            else "HopperModel"
        assert common.row_oracle(name, "cuda") == expect
        assert common.row_oracle(name, "cpu") == "HopperModel"
        own = spec_fingerprint(PORT[name])
        assert spec_fingerprint(common.timed_spec(name, "cpu")) == own
        timed = spec_fingerprint(common.timed_spec(name, "cuda"))
        if name in POLYBENCH_LAUNCH_ALIASES:
            assert timed == spec_fingerprint(matmul_spec(dtype_bytes=4))
        else:
            assert timed == own


def test_rows_timed_as_one_kernel_share_a_build(monkeypatch):
    """Rows whose timed spec is one kernel share one build and one driver,
    and Fig. 1's summary counts that kernel once, per oracle, with no
    median over rows of different oracles."""
    real = common.timed_spec
    shared = ("gemm", "corr")
    monkeypatch.setattr(
        common, "timed_spec", lambda name, device: (
            dataclasses.replace(PORT[name], name="matmul_b32")
            if name in shared else real(name, device)))
    _, drivers = common.build_suite_drivers(["gemm", "corr", "atax_k1"],
                                            device="cpu", cache=False)
    assert drivers["gemm"] is drivers["corr"]
    assert drivers["gemm"].spec.name == "matmul_b32"
    assert drivers["atax_k1"].spec.name == "atax_k1"
    rows = fig1_accuracy.summary([
        {"kernel": "gemm", "timed": "matmul_b32", "oracle": "CudaEventTimer",
         "ratio": 0.9},
        {"kernel": "corr", "timed": "matmul_b32", "oracle": "CudaEventTimer",
         "ratio": 0.9},
        {"kernel": "atax_k1", "timed": "atax_k1", "oracle": "HopperModel",
         "ratio": 0.5},
    ])
    assert rows == {
        "CudaEventTimer": {"median_ratio": 0.9, "good": 1, "rows": 1},
        "HopperModel": {"median_ratio": 0.5, "good": 0, "rows": 1}}


def test_tpu_padding_and_lane_rules_gone():
    """The notional SIMT rows move what a CUDA kernel would (no 8-row or
    128-lane padding) and take warp granules in place of the TPU's lane and
    sublane rules."""
    for name in PORT:
        if _family(name) == "matmul":
            continue
        spec = PORT[name]
        tiles = {op.name: op.tile for op in spec.operands}
        assert all(128 not in t and 8 not in t for t in tiles.values()), \
            (name, tiles)
        assert not any("% 128" in c or "% 8 " in c or c.endswith("% 8")
                       for c in spec.constraints), spec.constraints
        fam = _family(name)
        if fam == "matvec":
            assert tiles["vec"] == ("bc",) and tiles["out"] == ("br",)
            assert spec.constraints == ("bc % 32 == 0",)
        elif fam == "stencil":
            assert tiles["halo_c"] == ("br", 16)
            assert tiles["halo_r"] == (16, "bc")
            assert spec.constraints == ("bc % 32 == 0",)
        else:
            assert tiles["out"] == (1,) and spec.constraints == ()


def test_reduction_reads_its_input_once():
    """A reduction CTA reads br whole rows: the input crosses once, the
    partials once per CTA."""
    spec = PORT["reduce"]
    D = {"r": 2048, "c": 1024}
    table = spec.candidates(D, H100)
    tt = spec.traffic_table(D, table, H100)
    inp, out = tt.operands
    np.testing.assert_array_equal(inp.bytes(), np.full(len(table),
                                                       2048 * 1024 * 4.0))
    np.testing.assert_array_equal(out.bytes(), 2048 // table["br"] * 4.0)
    np.testing.assert_array_equal(tt.flops_total, 2048 * 1024 * 1.0)


def test_fig1_twin_median_at_least_085():
    """Fig. 1 at N 2048 over all 28 rows on HopperModel: the paper's bar is
    a median ratio of 0.85 (the reference's simulator run gives 0.913)."""
    rows = fig1_accuracy.run(device="cpu")
    assert [r["kernel"] for r in rows] == list(PORT)
    assert {r["oracle"] for r in rows} == {"HopperModel"}
    s = fig1_accuracy.summary(rows)["all"]
    by_family = {f: float(np.median([r["ratio"] for r in rows
                                     if _family(r["kernel"]) == f]))
                 for f in FAMILIES}
    print(f"Fig. 1 twin: median {s['median_ratio']:.3f}, good "
          f"{s['good']}/{s['rows']}, by family "
          + ", ".join(f"{f} {m:.3f}" for f, m in by_family.items()))
    assert s["median_ratio"] >= 0.85
    assert all(0.0 < r["ratio"] <= 1.0 + 1e-12 for r in rows)


def test_table1_twin_rows_and_oracles():
    rows = table1_configs.run(device="cpu")
    assert len(rows) == 2 * len(table1_configs.DEFAULT_KERNELS)
    assert {r["N"] for r in rows} == set(table1_configs.SIZES)
    assert {r["oracle"] for r in rows} == {"HopperModel"}
    lines = table1_configs.main(["--device", "cpu"])
    assert all(ln.endswith("oracle=HopperModel") for ln in lines)


def test_fig3_twin_klaraptor_cheaper_than_exhaustive():
    """Fig. 3 on HopperModel: KLARAPTOR's cost is below exhaustive search's
    for every kernel; the f32 matmul has no feasible tile at N 32."""
    rows = fig3_system_time.run(device="cpu")
    assert [r["kernel"] for r in rows] == list(fig3_system_time.KERNELS)
    for r in rows:
        assert r["klaraptor_s"] < r["exhaustive_s"], r
        assert "measured_speedup" not in r      # no card-timed row here
    gemm = rows[0]
    assert gemm["skipped_sizes"] == [32]
    lines = fig3_system_time.main(["--device", "cpu"])
    assert "skipped N=[32] (no feasible configuration)" in lines[0]


def test_fig4_twin_trends():
    rows = fig4_trends.run(device="cpu")
    assert [r["kernel"] for r in rows] == list(fig4_trends.KERNELS)
    for r in rows:
        assert np.isfinite(r["log_corr"]) and r["min_alignment"] >= 1.0


def test_suite_on_the_card_needs_a_card(monkeypatch):
    """The entry points default to the card, and without one they raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        common.build_suite_drivers(["gemm"])
    with pytest.raises(RuntimeError):
        quickstart.build()


@pytest.fixture()
def own_cache(tmp_path, monkeypatch):
    """An empty driver cache of the test's own and a registry left empty,
    so what the examples build and register meets no other test."""
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    yield
    registry.clear()


def test_examples_on_the_cpu(capsys, own_cache):
    result = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "oracle HopperModel" in out and "def choose(" in out
    for n in quickstart.SIZES:
        assert f"\n{n:>6} " in out
    assert result.driver.kernel == "matmul_b16"
    again = quickstart.main(["--device", "cpu"])
    assert again.from_cache and again.collected.n_probe_executions == 0
    assert "from the driver cache: True" in capsys.readouterr().out
    suite_example.main(["--device", "cpu", "--kernels", "gemm", "conv2d",
                        "reduce"])
    out = capsys.readouterr().out
    assert out.count("HopperModel") == 6 and "median ratio" in out


def test_benchmark_runner_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               KLARAPTOR_CACHE_DIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for prefix in ("fig1/summary_all,", "table1/gemm@N1024,",
                   "fig3/summary,", "fig4/corr,"):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    assert len([ln for ln in lines if ln.startswith("fig1/")]) == 28 + 2
