"""repro_torch.introspect: KernelSpecs derived from the port's CUDA kernels.

The port of tests/test_introspect.py's checks of the same behaviour, on the
CPU (registers from the kernels' ``__launch_bounds__`` caps; the compiled
counts are read on the card by chip_smoke.py [17]):

  * the derived matmul and grouped-matmul specs behave exactly as the
    hand-written ones -- the same candidates, traffic, oracle times and,
    through drivers built on ``HopperModel``, the same chosen configs at the
    reference's TestTier1Equivalence shapes (the check the reference's own
    introspection cannot pass on this jax);
  * the two auto-specced kernels (layernorm fusion, blocked column sum) run
    the whole pipeline with no hand-written spec: introspect -> collect /
    fit -> choose -> the tuned ops, and the launcher's ``--auto-kernels``;
  * trace points, grid and residency reconstruction, threads, the stage
    self-check, the Hopper granularity rule, the FLOP-hint rule, the source
    fingerprint and ``auto_register``'s idempotence.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              choose_or_default, gmm_probe_data, matmul_spec,
                              registry, selection_ratio)
from repro_torch.introspect import (CudaKernel, GridSpec, IntrospectError,
                                    LaunchDescription, OperandLaunch,
                                    auto_kernels, auto_register,
                                    capture_kernel, derive_kernel, get_auto,
                                    spec_from_kernel, trace_points)
from repro_torch.core.device_model import (DeviceModel, ProbeBatch,
                                           roofline_times)
from repro_torch.core.kernel_spec import SM90_SMEM_EXTRA
from repro_torch.introspect.tier1 import (EQUIV_SHAPES, matmul_grid_spec,
                                         moe_gmm_grid_spec, tier1_pairs)
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import MATMUL
from repro_torch.kernels.layernorm import (LAYERNORM, LN_REGS_PER_THREAD,
                                           layernorm_grid_spec,
                                           layernorm_plain)
from repro_torch.kernels.reduce import COLSUM, colsum_grid_spec


@pytest.fixture(scope="module")
def pairs():
    """(hand spec, derived spec, kernel, GridSpec) per hand-specced kernel."""
    return {hand.name: (hand, spec_from_kernel(k, gs, device="cpu"), k, gs)
            for k, gs, hand in tier1_pairs()}


@pytest.fixture(scope="module")
def built_pairs(pairs):
    """Drivers built from the hand and the derived spec with identical
    probe settings and noise streams."""
    out = {}
    for name, (hand, intro, _, _) in pairs.items():
        probes = gmm_probe_data() if name.startswith("moe_gmm") else None
        drivers = []
        for spec in (hand, intro):
            drivers.append(Klaraptor(HopperModel(noise=0.03, seed=3),
                                     cache=False).build_driver(
                spec, probe_data=probes, repeats=2, max_configs_per_size=12,
                register=False).driver)
        out[name] = tuple(drivers)
    return out


class TestTier1Equivalence:
    @pytest.mark.parametrize("name", sorted(EQUIV_SHAPES))
    def test_structural_equivalence(self, pairs, name):
        """Same candidates, launch geometry, traffic and oracle times at
        every representative shape."""
        hand, intro, _, _ = pairs[name]
        assert intro.data_params == hand.data_params
        assert intro.program_params == hand.program_params
        assert intro.threads == hand.threads
        assert intro.regs_per_thread == hand.regs_per_thread
        assert intro.flops_per_point == hand.flops_per_point
        oracle = HopperModel(noise=0.0)
        for D in EQUIV_SHAPES[name]:
            th, ti = hand.candidates(D, H100), intro.candidates(D, H100)
            assert len(th) == len(ti) > 0
            for p in th.params:
                np.testing.assert_array_equal(th[p], ti[p])
            tth, tti = hand.traffic_table(D, th), intro.traffic_table(D, ti)
            for f in ("ctas", "seq_iters", "threads", "stage_bytes",
                      "blocks_per_sm", "grid_steps", "flops_total"):
                np.testing.assert_array_equal(getattr(tth, f),
                                              getattr(tti, f), err_msg=f)
            np.testing.assert_array_equal(oracle.true_time_batch(tth),
                                          oracle.true_time_batch(tti))

    @pytest.mark.parametrize("name", sorted(EQUIV_SHAPES))
    def test_chosen_configs_identical(self, built_pairs, name):
        drv_h, drv_i = built_pairs[name]
        for D in EQUIV_SHAPES[name]:
            assert drv_h.choose(D) == drv_i.choose(D), D

    def test_feasibility_agrees(self, pairs):
        hand, intro, _, _ = pairs["matmul_b16"]
        from repro_torch.core import CandidateTable
        D = {"m": 1024, "n": 1024, "k": 1024}
        rows = [{"bm": 128, "bn": 128, "bk": 32},
                {"bm": 8, "bn": 64, "bk": 8},          # 8 threads
                {"bm": 100, "bn": 128, "bk": 32},      # misaligned bm
                {"bm": 2048, "bn": 128, "bk": 32}]     # bm > m
        t = CandidateTable.from_rows(hand.program_params, rows)
        np.testing.assert_array_equal(hand.feasible_mask(D, t),
                                      intro.feasible_mask(D, t))


class TestDerivation:
    def test_trace_points_unambiguous(self):
        (D1, P1), (D2, P2) = trace_points(moe_gmm_grid_spec())
        vals1 = list(D1.values()) + list(P1.values())
        assert len(set(vals1)) == len(vals1)
        assert all(P1[p] != P2[p] for p in P1)
        assert all(D1[d] != D2[d] for d in D1)

    @pytest.mark.parametrize("which", ["matmul", "moe_gmm", "layernorm",
                                       "colsum"])
    def test_derived_grid_reproduces_both_captures(self, which):
        kernel, gs = {
            "matmul": tier1_pairs()[0][:2],
            "moe_gmm": tier1_pairs()[1][:2],
            "layernorm": (LAYERNORM, layernorm_grid_spec(512)),
            "colsum": (COLSUM, colsum_grid_spec()),
        }[which]
        spec = spec_from_kernel(kernel, gs, device="cpu")
        for D, P in trace_points(gs):
            cap = capture_kernel(kernel, gs, D, P, device="cpu")
            env = {**D, **P}
            assert tuple(int(round(float(a.extent_expr().eval(env))))
                         for a in spec.grid) == cap.grid
            assert [a.sequential for a in spec.grid] == \
                [i >= cap.n_parallel for i in range(len(cap.grid))]
            assert [a.ragged for a in spec.grid] == \
                [i in cap.ragged for i in range(len(cap.grid))]
            assert float(spec.threads.eval(env)) == cap.threads
            assert float(spec.stage_expr().eval(env)) == cap.smem_bytes

    def test_grouped_matmul_expert_axis_squeezed(self, pairs):
        """The expert's literal-1 tile dim is squeezed; the bf16 kernel's
        ring (the other three slots and its barriers) is scratch."""
        _, intro, _, _ = pairs["moe_gmm_b16"]
        assert intro.grid[0].data == "e" and intro.grid[0].block is None
        assert [op.tile for op in intro.operands] == \
            [("bg", "bk"), ("bk", "bn"), ("bg", "bn"), (3, "bg", "bk"),
             (3, "bk", "bn"), (SM90_SMEM_EXTRA,)]
        assert [op.scratch for op in intro.operands] == [False] * 3 + [True] * 3

    def test_layernorm_gamma_beta_resident(self):
        """gamma and beta depend on no axis: staged once per CTA, so their
        traffic is one (c,) f32 tile per CTA, never per row."""
        spec = spec_from_kernel(LAYERNORM, layernorm_grid_spec(512),
                                device="cpu")
        x, res, gamma, beta, out = spec.operands
        for op in (gamma, beta):
            assert op.deps == () and op.staged and op.tile == (512,)
            assert op.dtype_bytes == 4
        assert x.deps == res.deps == out.deps == (spec.grid[0].name,)
        assert out.is_output and not x.staged
        D = {"r": 4096}
        t = spec.candidates(D, H100)
        tt = spec.traffic_table(D, t, H100)
        by_name = {op.name: op for op in tt.operands}
        np.testing.assert_array_equal(by_name[gamma.name].fetches, tt.ctas)
        np.testing.assert_array_equal(tt.ctas, 4096 // t["br"])
        np.testing.assert_array_equal(tt.stage_bytes, 2 * 512 * 4)

    def test_layernorm_row_axis_ragged(self):
        """The kernel masks its last row block, so the derived row axis is
        ragged and a row tile need not divide r; the column sum's axes are
        not."""
        spec = spec_from_kernel(LAYERNORM, layernorm_grid_spec(512),
                                device="cpu")
        (rows,) = spec.grid
        assert (rows.data, rows.block, rows.ragged) == ("r", "br", True)
        assert 128 in spec.candidates({"r": 4097}, H100)["br"]
        cs = spec_from_kernel(COLSUM, colsum_grid_spec(), device="cpu")
        assert [a.data for a in cs.grid] == ["c", "r"]
        assert not any(a.ragged or a.sequential for a in cs.grid)
        assert 128 not in cs.candidates({"r": 4097, "c": 2048}, H100)["br"]

    def test_colsum_output_written_once_per_column_block(self):
        """The row splits are a parallel axis; the output depends on the
        column blocks only, so its traffic is written once per column block
        although every CTA of a block runs; the workspace's partial sums
        are written and read back once per CTA."""
        spec = spec_from_kernel(COLSUM, colsum_grid_spec(), device="cpu")
        cols, rows = spec.grid
        assert (cols.data, cols.block, cols.sequential) == ("c", "bc", False)
        assert (rows.data, rows.block, rows.sequential) == ("r", "br", False)
        x, part_out, part_in, out, scratch = spec.operands
        assert x.deps == part_out.deps == part_in.deps == (cols.name,
                                                           rows.name)
        assert part_out.is_output and not part_in.is_output
        assert out.is_output and out.deps == (cols.name,)
        assert out.tile == ("bc",) and out.dtype_bytes == 4
        assert scratch.scratch and scratch.tile == (8, "bc")
        D = {"r": 8192, "c": 4096}
        t = spec.candidates(D, H100)
        tt = spec.traffic_table(D, t, H100)
        x_t, po_t, pi_t, out_t = tt.operands   # scratch moves no bytes
        np.testing.assert_array_equal(tt.seq_iters, 1)
        np.testing.assert_array_equal(tt.ctas,
                                      (4096 // t["bc"]) * (8192 // t["br"]))
        np.testing.assert_array_equal(out_t.fetches, 4096 // t["bc"])
        np.testing.assert_array_equal(x_t.fetches, tt.ctas)
        np.testing.assert_array_equal(x_t.bytes(), 2 * 8192 * 4096)
        np.testing.assert_array_equal(out_t.bytes(), np.full(len(t), 4 * 4096))
        for part in (po_t, pi_t):
            np.testing.assert_array_equal(part.bytes(),
                                          4 * 4096 * (8192 // t["br"]))

    @pytest.mark.parametrize("bc", [128, 512])
    def test_colsum_ctas_grow_with_row_splits(self, bc):
        """The derived CTA count is (c / bc) (r / br): it grows with the
        row splits r / br."""
        spec = spec_from_kernel(COLSUM, colsum_grid_spec(), device="cpu")
        D = {"r": 8192, "c": 4096}
        brs = (8, 64, 512, 2048)
        t = CandidateTable.from_rows(("br", "bc"),
                                     [{"br": br, "bc": bc} for br in brs])
        tt = spec.traffic_table(D, t, H100)
        np.testing.assert_array_equal(
            tt.ctas, [(4096 // bc) * (8192 // br) for br in brs])
        assert np.all(np.diff(tt.ctas) < 0)

    def test_hopper_granularity_rule(self, pairs):
        """Every program parameter that sizes a tile is a multiple of the
        kernel's granule -- 64 for the bf16 wgmma matmul, 8 for the f32 SIMT
        one and by default; one that sizes none gets no granularity
        constraint."""
        hand, intro, _, _ = pairs["matmul_b16"]
        f32 = spec_from_kernel(MATMUL, matmul_grid_spec(4), device="cpu")
        for p in ("bm", "bn", "bk"):
            assert f"{p} % 64 == 0" in intro.constraints
            assert intro.alignment(p) == hand.alignment(p) == 64
            assert f"{p} % 8 == 0" in f32.constraints
            assert f32.alignment(p) == matmul_spec(4).alignment(p) == 8
        spec = spec_from_kernel(_toy_kernel(), _toy_grid_spec(),
                                device="cpu")
        assert "bm % 8 == 0" in spec.constraints
        assert not any(c.startswith("nt %") for c in spec.constraints)
        assert spec.threads == _expected_toy_threads()

    def test_p_dependent_flops_need_hint(self):
        gs = _toy_grid_spec()
        kernel = _toy_kernel(flops=lambda m, bm: 2.0 * m * bm)
        with pytest.raises(IntrospectError, match="flops_per_point"):
            spec_from_kernel(kernel, gs, device="cpu")
        gs.flops_per_point = 3.0
        assert spec_from_kernel(kernel, gs, device="cpu"
                                ).flops_per_point == 3.0

    def test_threads_no_product_fits_raises(self):
        kernel = _toy_kernel(threads=lambda bm, nt: bm + nt)
        with pytest.raises(IntrospectError, match="threads"):
            spec_from_kernel(kernel, _toy_grid_spec(), device="cpu")

    def test_shared_memory_not_the_staged_tiles_raises(self):
        kernel = _toy_kernel(smem=lambda bm: 4 * bm + 16)
        with pytest.raises(IntrospectError, match="shared-memory"):
            spec_from_kernel(kernel, _toy_grid_spec(), device="cpu")

    def test_cpu_registers_are_the_launch_bounds_cap(self):
        spec, cap = derive_kernel(LAYERNORM, layernorm_grid_spec(512),
                                  device="cpu")
        assert cap.attributes_source == "launch_bounds"
        assert spec.regs_per_thread == cap.num_regs == LN_REGS_PER_THREAD
        assert cap.local_bytes is None

    def test_cuda_registers_need_the_compiled_kernel(self):
        if torch.cuda.is_available():
            pytest.skip("reads the compiled kernel where there is a card")
        with pytest.raises(RuntimeError):
            spec_from_kernel(COLSUM, colsum_grid_spec())


class TestSourceFingerprint:
    def test_stable_across_derivations(self):
        s1 = spec_from_kernel(COLSUM, colsum_grid_spec(), device="cpu")
        s2 = spec_from_kernel(COLSUM, colsum_grid_spec(), device="cpu")
        assert s1.source_fingerprint == s2.source_fingerprint != ""

    def test_changes_with_eps_and_dtype(self):
        """The fingerprint covers the static keyword arguments and the
        instantiation (the cache keys that will fold it in wait for the
        artifact cache)."""
        fp = [spec_from_kernel(LAYERNORM, gs, device="cpu").source_fingerprint
              for gs in (layernorm_grid_spec(512),
                         layernorm_grid_spec(512, eps=1e-3),
                         layernorm_grid_spec(512, dtype_bytes=4))]
        assert len(set(fp)) == 3

    def test_hand_spec_fingerprint_unset(self):
        assert matmul_spec().source_fingerprint == ""


class TestAutoKernelPipeline:
    def test_end_to_end_zero_hand_spec(self):
        """introspect -> collect / fit -> choose -> tuned ops, for both auto
        kernels, no hand-written spec anywhere."""
        from repro_torch.launch import build_auto_kernels

        registry.clear()
        oracle = HopperModel(noise=0.03, seed=5)
        try:
            kernels = build_auto_kernels(d_model=512, tune_device=oracle,
                                         device="cpu")
            assert [ak.name for ak in kernels] == \
                ["layernorm_c512_b16", "colsum_b16"]
            for ak in kernels:
                D = ({"r": 4096} if "layernorm" in ak.name
                     else {"r": 4096, "c": 2048})
                drv = registry.get(ak.name)
                assert drv is not None
                r = selection_ratio(ak.spec, oracle, drv, D, H100)
                assert r["ratio"] >= 0.7, r
                assert choose_or_default(ak.name, D, ak.defaults) == \
                    drv.choose(D) == ak.choose(D)
                assert ak.ensure_driver(oracle) is drv
            rng = np.random.RandomState(4)
            x, res = (torch.from_numpy(rng.randn(4096, 512).astype(
                np.float32)).to(torch.bfloat16) for _ in range(2))
            g, b = (torch.from_numpy(rng.randn(512).astype(np.float32))
                    for _ in range(2))
            torch.testing.assert_close(ops.layernorm(x, res, g, b),
                                       layernorm_plain(x, res, g, b))
        finally:
            registry.clear()

    def test_fit_config_uses_derived_alignment(self):
        ak = auto_register(COLSUM, colsum_grid_spec(), device="cpu")
        assert ak.alignments() == {"br": 8, "bc": 8}
        fitted = ak.fit_config({"br": 512, "bc": 1024}, {"r": 384, "c": 640})
        assert 384 % fitted["br"] == 0 and fitted["br"] % 8 == 0
        assert 640 % fitted["bc"] == 0 and fitted["bc"] % 8 == 0
        assert fitted == {"br": 384, "bc": 640}

    def test_fit_config_keeps_ragged_tiles(self):
        """A ragged axis's tile is kept, at most its extent rounded up to the
        derived granularity."""
        ak = auto_register(LAYERNORM, layernorm_grid_spec(512), device="cpu")
        assert ak.fit_config({"br": 128}, {"r": 4097}) == {"br": 128}
        assert ak.fit_config({"br": 2048}, {"r": 100}) == {"br": 104}

    def test_auto_register_idempotent(self):
        a1 = auto_register(COLSUM, colsum_grid_spec(), device="cpu")
        a2 = auto_register(COLSUM, colsum_grid_spec(), device="cpu")
        assert a1 is a2
        assert get_auto(a1.name) is a1
        assert a1.name in auto_kernels()
        gs = colsum_grid_spec()
        gs.defaults = {"br": 64, "bc": 256}
        a3 = auto_register(COLSUM, gs, device="cpu")
        assert a3 is not a1 and get_auto(a1.name) is a3
        assert a3.defaults == {"br": 64, "bc": 256}
        auto_register(COLSUM, colsum_grid_spec(), device="cpu")

    def test_plan_envelope_uses_probe_hints(self, pairs):
        from repro_torch.introspect import AutoKernel
        _, intro, kernel, gs = pairs["moe_gmm_b16"]
        ak = AutoKernel(spec=intro, grid_spec=gs, kernel=kernel,
                        capture=None)
        env = ak.plan_envelope(sizes=(256, 512))
        assert env == {"e": [2, 4], "g": [256, 512], "k": [256, 512],
                       "n": [256, 512]}

    def test_launcher_prints_auto_kernels_and_serves(self, capsys):
        from repro_torch.launch.serve import main

        registry.clear()
        try:
            done = main(["--arch", "llama3.2-1b", "--smoke", "--auto-kernels",
                         "--device", "cpu", "--requests", "3", "--max-new",
                         "3", "--batch", "2"])
        finally:
            registry.clear()
        out = capsys.readouterr().out
        assert "auto kernel layernorm_c128_b16: 5 operands, grid rank 1" \
            in out
        assert "auto kernel colsum_b16: 5 operands, grid rank 2" in out
        assert "registers 64 (launch_bounds; launch-bounds cap 64)" in out
        assert sorted(r.rid for r in done) == [0, 1, 2]
        assert all(r.done and 1 <= len(r.output) <= 3 for r in done)
        for rid in range(3):
            assert f"req {rid}: prompt=" in out


# -- a toy kernel for the derivation's error paths ---------------------------

def _toy_grid_spec() -> GridSpec:
    return GridSpec(name="toy", data_params=("m",),
                    program_params=("bm", "nt"),
                    make_args=lambda D: (((D["m"],), torch.float32),))


def _expected_toy_threads():
    from repro_torch.core.rational_program import const, var
    return var("nt") * const(32.0)


def _toy_kernel(flops=lambda m, bm: 2.0 * m,
                threads=lambda bm, nt: 32 * nt,
                smem=lambda bm: 4 * bm) -> CudaKernel:
    """A launch of m / bm CTAs of 32 * nt threads, each staging a (bm,) f32
    tile; ``nt`` sizes no tile."""
    def describe(args, *, bm, nt):
        ((shape, dt),) = args
        m = shape[0]
        return LaunchDescription(
            grid=(-(-m // bm),), loops=(), threads=threads(bm, nt),
            smem_bytes=smem(bm),
            operands=(OperandLaunch((bm,), (0,), dt, staged=True),
                      OperandLaunch((bm,), (0,), dt, is_output=True)),
            flops=flops(m, bm), dtype=dt)

    def no_card(dtype):
        raise RuntimeError("the toy kernel has no compiled library")

    return CudaKernel(source="colsum", describe=describe, launch=None,
                      attributes=no_card, regs_cap=32)


# The layernorm_c2048_b16 kernel's time in us on the card, each row tile at
# the probe sizes (r 512, 2048, 8192) and the sizes chip_smoke.py [18]
# chooses for (4096, 16384, 4097): the median of 7 launches, each after the
# timer's L2 flush, and the same without the flush (the timer before the
# repair), as chip_smoke.py [18] printed them ("layernorm card us by r and
# br"; NVIDIA H100 80GB HBM3, 700 W power limit).
H100_LAYERNORM_US = {
    512: {8: 12.42, 16: 18.27, 32: 28.96, 64: 50.94, 128: 95.49, 256: 181.82,
          512: 355.58},
    2048: {8: 16.83, 16: 19.46, 32: 29.44, 64: 52.1, 128: 96.03, 256: 184.99,
           512: 363.17, 1024: 712.93, 2048: 1408.67},
    4096: {8: 27.04, 16: 26.62, 32: 32.67, 64: 54.91, 128: 99.65,
           256: 186.85, 512: 364.83, 1024: 718.43, 2048: 1425.22},
    4097: {8: 26.94, 16: 26.88, 32: 32.86, 64: 55.17, 128: 99.74,
           256: 186.88, 512: 363.55, 1024: 717.22, 2048: 1416.54},
    8192: {8: 47.65, 16: 44.22, 32: 46.5, 64: 62.75, 128: 106.62,
           256: 195.17, 512: 367.3, 1024: 720.8, 2048: 1428.0},
    16384: {8: 85.54, 16: 86.14, 32: 80.54, 64: 87.87, 128: 120.96,
            256: 211.68, 512: 389.28, 1024: 738.66, 2048: 1448.45},
}

H100_LAYERNORM_NO_FLUSH_US = {
    512: {8: 10.08, 16: 14.53, 32: 23.04, 64: 38.94, 128: 70.3, 256: 133.38,
          512: 257.92},
    2048: {8: 14.14, 16: 15.14, 32: 23.46, 64: 39.42, 128: 73.89,
           256: 138.82, 512: 267.26, 1024: 522.05, 2048: 1032.1},
    4096: {8: 25.54, 16: 29.12, 32: 37.41, 64: 59.65, 128: 105.06,
           256: 192.61, 512: 321.7, 1024: 628.7, 2048: 1239.01},
    4097: {8: 25.5, 16: 29.18, 32: 37.15, 64: 59.74, 128: 103.58,
           256: 191.26, 512: 328.38, 1024: 635.04, 2048: 1250.78},
    8192: {8: 49.09, 16: 46.78, 32: 50.11, 64: 66.69, 128: 112.67,
           256: 201.57, 512: 377.86, 1024: 728.54, 2048: 1433.5},
    16384: {8: 88.03, 16: 88.96, 32: 83.52, 64: 90.85, 128: 125.86,
            256: 219.81, 512: 398.21, 1024: 748.7, 2048: 1452.16},
}


class _RecordedCard(DeviceModel):
    """The card's recorded layernorm times as an oracle: each probe gets
    the recorded time, split by the roofline rule as ``CudaEventTimer``
    splits what it measures."""

    def __init__(self, us: dict):
        self.hw = H100
        self.us = us

    def _times(self, table) -> np.ndarray:
        r = int(table.D["r"])
        return np.array([self.us[r][int(b)] * 1e-6
                         for b in table.config["br"]])

    def probe_batch(self, table, rng=None, repeats=1):
        total = np.tile(self._times(table), (repeats, 1))
        t_mem, t_cmp = roofline_times(table, self.hw)
        mem = total * (t_mem / (t_mem + t_cmp))[None, :]
        return ProbeBatch(total_time_s=total, mem_time_s=mem,
                          compute_time_s=total - mem,
                          grid_steps=np.asarray(table.grid_steps),
                          stage_bytes=np.asarray(table.stage_bytes),
                          blocks_resident=np.asarray(table.blocks_resident))

    def true_time_batch(self, table):
        return self._times(table)


class TestLayernormChoiceOnTheCard:
    """The layernorm auto kernel chose br 32 at r 4096 on the card, where
    br 8 ran 1.45x faster (selection ratio 0.69).  The cause: the timer ran
    each probe back to back on the same inputs, so at r 512 and 2048 (4-16
    MB in) every launch re-read what the previous one left in the 50 MB L2,
    while at the sizes it chooses for the inputs come from device memory;
    every tile looked 1.2-1.4x faster in those probes than L2-cold, and the
    fit took a latency-bound CTA (br 32: one per SM, 8 warps each walking 4
    rows) to be as fast at r 4096 as at r 2048.  And 8 probes
    of 9 candidates per size dropped br 8 at r 8192, the one probe of many
    small CTAs.  The repair: the timer flushes the L2 before every timed
    launch, and the auto build probes every candidate of the layernorm."""

    def test_timer_flushes_l2_before_every_timed_launch(self, monkeypatch):
        from repro_torch.core import device_model as dm

        log = []

        class Event:
            def __init__(self, enable_timing):
                pass

            def record(self, stream=None):
                log.append("event")

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return 0.01

        class Buffer:
            def sum(self):
                log.append("flush")

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep",
                            lambda cycles: log.append("spin"))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: None)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        timer = object.__new__(dm.CudaEventTimer)
        timer.hw, timer.device = H100, torch.device("cpu")
        timer.warmup, timer.timings, timer.seed = 1, 3, 0
        timer._bound, timer._flush = None, Buffer()
        monkeypatch.setattr(timer, "_launch_fn", lambda kernel, D: (
            lambda P: log.append("launch")))
        spec = matmul_spec(4)
        table = spec.candidates({"m": 256, "n": 256, "k": 256}, H100)
        tt = spec.traffic_table({"m": 256, "n": 256, "k": 256},
                                table.select(np.arange(2)), H100)
        timer._time_rows(tt, 3)
        timed = ["flush", "spin", "event", "launch", "event"]
        assert log == (["launch"] + timed * 3) * 2

        # the flush reads twice the L2's bytes
        small = object.__new__(dm.CudaEventTimer)
        small.hw = dataclasses.replace(H100, l2_bytes=4096)
        small.device, small._flush = torch.device("cpu"), None
        small._flush_l2()
        assert small._flush.numel() * small._flush.element_size() == 8192

    def test_auto_build_probes_every_layernorm_tile(self):
        from repro_torch.launch import build_auto_kernels

        registry.clear()
        try:
            ak, _ = build_auto_kernels(
                d_model=2048, tune_device=HopperModel(noise=0.03, seed=5),
                device="cpu")
            cols = ak.build.collected.columns
            for r in ak.grid_spec.probe_hints["r"]:
                probed = set(cols["br"][cols["r"] == r].tolist())
                feasible = set(ak.spec.candidates({"r": r}, H100)["br"]
                               .tolist())
                assert probed == feasible, (r, sorted(feasible - probed))
        finally:
            registry.clear()

    def test_layernorm_chooses_well_on_recorded_card_times(self):
        """The auto build's probes and fit, fed the card's L2-cold times,
        choose within 0.85 of the card's best at every chosen-for size.
        Either fault alone brings back br 32 at r 4096: the times the timer
        took without the flush, or 8 probes of the 9 tiles per size."""
        from repro_torch.launch.serve import AUTO_PROBES_PER_SIZE

        cold = _RecordedCard(H100_LAYERNORM_US)
        sizes = ({"r": 4096}, {"r": 16384}, {"r": 4097})
        registry.clear()
        try:
            ak = auto_register(LAYERNORM, layernorm_grid_spec(2048),
                               device="cpu")
            drv = ak.ensure_driver(cold, repeats=2,
                                   max_configs_per_size=AUTO_PROBES_PER_SIZE)
            for D in sizes:
                sel = selection_ratio(ak.spec, cold, drv, D, H100)
                assert sel["ratio"] >= 0.85, sel
        finally:
            registry.clear()
        for probes, per_size in (
                (_RecordedCard(H100_LAYERNORM_NO_FLUSH_US),
                 AUTO_PROBES_PER_SIZE), (cold, 8)):
            drv = Klaraptor(probes, device="cpu", cache=False).build_driver(
                ak.spec, probe_data=ak.probe_data(), repeats=2,
                max_configs_per_size=per_size, register=False).driver
            assert drv.choose(sizes[0]) == {"br": 32}
            assert selection_ratio(ak.spec, cold, drv, sizes[0],
                                   H100)["ratio"] < 0.85
