"""The port's bucketed dispatch against the JAX package's, on the CPU: the
static shape lattice, the branch-index decision, the in-graph ops, and the
pow2 prefill chunking that rides on it.

The classes mirror ``tests/test_buckets.py``'s of the same names:

* host (``bucket_of``) and device (``bucket_keys``, torch ops) rounding are
  bit-identical on every value of a sweep, including the lattice edges and
  the out-of-range boundary, and both equal the JAX package's host and
  jitted rounding;
* ``BucketedDispatch.branch_index`` (torch ops, no host sync) agrees with
  ``host_index`` on hits, unplanned buckets and out-of-range misses, and
  with the JAX dispatch built over the same table;
* the in-graph ops (``in_graph=``) serve many raw shapes from one step
  object per branch (``serving.graphs.BranchGraphs``), with sliced outputs
  equal to the unpadded products within the kernel tests' tolerances
  (2e-4 in f32);
* ``ServingEngine._pow2_chunks`` is the JAX engine's, case for case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BucketLattice as RefLattice
from repro.core import V5E
from repro.core.device_plan import BucketedDispatch as RefDispatch
from repro.core.plan import LaunchPlanTable as RefTable
from repro.serving.engine import ServingEngine as RefEngine

from repro_torch.core import (H100, BucketedDispatch, BucketLattice,
                              LaunchPlanTable, build_bucketed_dispatch,
                              matmul_spec, pad_to, pow2_span, registry,
                              set_choice_listener)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.layernorm import layernorm_plain
from repro_torch.kernels.reduce import colsum_plain
from repro_torch.serving import ServingEngine
from repro_torch.serving.graphs import BranchGraphs

F32_TOL = 2e-4          # tests/test_kernels.py's f32 tolerance


# ---------------------------------------------------------------------------
# Lattice primitives
# ---------------------------------------------------------------------------

class TestPrimitives:
    def test_pow2_span(self):
        assert pow2_span(64, 1024) == (64, 128, 256, 512, 1024)
        assert pow2_span(65, 1024) == (128, 256, 512, 1024)
        assert pow2_span(512, 512) == (512,)
        assert pow2_span(1, 1) == (1,)
        assert pow2_span(0, 4) == (1, 2, 4)
        from repro.core import pow2_span as ref_span
        for lo in (0, 1, 2, 3, 7, 64, 65, 1000):
            for hi in (1, 4, 63, 64, 65, 4096):
                assert pow2_span(lo, hi) == ref_span(lo, hi), (lo, hi)

    def test_pad_to(self):
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        out = pad_to(x, (4, 3))
        assert out.shape == (4, 3)
        assert torch.equal(out[2:], torch.zeros(2, 3))
        assert torch.equal(out[:2], x)
        # None keeps a dimension; an exact match is the identity object
        assert pad_to(x, (None, 5)).shape == (2, 5)
        assert pad_to(x, (2, 3)) is x
        with pytest.raises(ValueError, match="smaller than extent"):
            pad_to(x, (1, 3))
        # the same zeros where the JAX package pads
        from repro.core import pad_to as ref_pad
        ref = np.asarray(ref_pad(jnp.asarray(x.numpy()), (4, 5)))
        np.testing.assert_array_equal(pad_to(x, (4, 5)).numpy(), ref)

    def test_from_axes_validates(self):
        lat = BucketLattice.from_axes("k", {"m": [256, 64, 64, 128]})
        assert lat.axes == (("m", (64, 128, 256)),)
        with pytest.raises(ValueError, match="positive"):
            BucketLattice.from_axes("k", {"m": [0, 64]})
        with pytest.raises(ValueError, match="positive"):
            BucketLattice.from_axes("k", {"m": []})


# ---------------------------------------------------------------------------
# Host/device rounding bit-identity
# ---------------------------------------------------------------------------

class TestRounding:
    AXES = {"m": [8, 64, 256], "n": [128, 512]}
    LAT = BucketLattice.from_axes("k", AXES)
    MS = [0, 1, 7, 8, 9, 63, 64, 65, 255, 256, 257, 1000]
    NS = [0, 1, 127, 128, 129, 511, 512, 513]

    def test_bucket_of_edges(self):
        lat = self.LAT
        assert lat.bucket_of({"m": 1, "n": 1}) == {"m": 8, "n": 128}
        assert lat.bucket_of({"m": 8, "n": 128}) == {"m": 8, "n": 128}
        assert lat.bucket_of({"m": 9, "n": 128}) == {"m": 64, "n": 128}
        assert lat.bucket_of({"m": 256, "n": 512}) == {"m": 256, "n": 512}
        # out of range: above the top, non-positive, missing param
        assert lat.bucket_of({"m": 257, "n": 128}) is None
        assert lat.bucket_of({"m": 0, "n": 128}) is None
        assert lat.bucket_of({"m": 8}) is None
        # extra keys ignored
        assert lat.bucket_of({"m": 8, "n": 128, "zz": 1}) is not None

    def test_host_graph_bit_identical_sweep(self):
        """Every (m, n) of a sweep spanning in-range values, the edges and
        out-of-range values: the port's device rounding (torch ops) agrees
        with its host rounding exactly -- keys on hits, the in_range mask
        on misses -- and both with the JAX package's jitted
        ``bucket_keys`` and host ``bucket_of``."""
        lat, ref = self.LAT, RefLattice.from_axes("k", self.AXES)

        @jax.jit
        def ref_round(raw):
            return ref.bucket_keys(raw)

        for m in self.MS:
            for n in self.NS:
                keys, in_range = lat.bucket_keys(
                    torch.tensor([m, n], dtype=torch.int32))
                assert keys.dtype == torch.int32 and \
                    in_range.dtype == torch.bool
                rkeys, rin = ref_round(jnp.asarray([m, n], dtype=jnp.int32))
                host = lat.bucket_of({"m": m, "n": n})
                assert host == ref.bucket_of({"m": m, "n": n}), (m, n)
                assert bool(in_range) == bool(rin) == (host is not None)
                # the keys agree with JAX's even where the mask is off
                assert keys.tolist() == [int(v) for v in np.asarray(rkeys)]
                if host is not None:
                    assert keys.tolist() == [host["m"], host["n"]], (m, n)

    def test_padding_waste(self):
        lat = self.LAT
        ref = RefLattice.from_axes("k", self.AXES)
        assert lat.padding_waste({"m": 8, "n": 128}) == 0.0
        w = lat.padding_waste({"m": 32, "n": 128})
        assert w == pytest.approx(1.0 - 32 / 64)
        assert lat.padding_waste({"m": 999, "n": 128}) == 0.0  # miss
        for m in self.MS:
            D = {"m": m, "n": 300}
            assert lat.padding_waste(D) == ref.padding_waste(D)

    def test_introspection(self):
        lat = self.LAT
        assert lat.data_params == ("m", "n")
        assert lat.n_buckets == 6
        assert lat.envelope() == {"m": [8, 64, 256], "n": [128, 512]}
        assert lat.envelope_shape() == {"m": 256, "n": 512}
        assert len(lat.all_buckets()) == 6
        assert {"m": 8, "n": 128} in lat.all_buckets()
        assert lat.all_buckets() == \
            RefLattice.from_axes("k", self.AXES).all_buckets()


# ---------------------------------------------------------------------------
# Feasibility-derived construction
# ---------------------------------------------------------------------------

class _StubSpec:
    """Spec stand-in with a controllable feasibility frontier."""
    name = "stub"
    data_params = ("m", "k")

    def candidates(self, D, hw):
        return [object()] if D["m"] <= 256 and D["k"] <= 512 else []


class TestFromSpec:
    def test_trims_infeasible_top(self):
        lat = BucketLattice.from_spec(_StubSpec(), {"m": (16, 1024),
                                                    "k": (64, 512)})
        assert dict(lat.axes)["m"] == (16, 32, 64, 128, 256)
        assert dict(lat.axes)["k"] == (64, 128, 256, 512)

    def test_fixed_params_skip_feasibility(self):
        lat = BucketLattice.from_spec(_StubSpec(), {"m": (16, 256)},
                                      fixed={"k": [7, 9999]})
        assert dict(lat.axes)["k"] == (7, 9999)

    def test_no_feasible_values_raises(self):
        with pytest.raises(ValueError, match="no feasible"):
            BucketLattice.from_spec(_StubSpec(), {"m": (512, 1024),
                                                  "k": (64, 64)})

    def test_real_spec_orders_by_data_params(self):
        spec = matmul_spec()
        lat = BucketLattice.from_spec(
            spec, {"k": (512, 512), "m": (64, 256), "n": (256, 256)})
        assert lat.data_params == tuple(
            d for d in spec.data_params if d in ("m", "n", "k"))

    def test_real_spec_feasibility_on_the_h100_table(self):
        """The bf16 matmul's compiled tiles are at least 64: from 64 up
        every point has one, below it none divides, and a base point with
        no candidate leaves every axis empty."""
        lat = BucketLattice.from_spec(
            matmul_spec(), {"m": (64, 512), "n": (256, 256),
                            "k": (512, 512)}, hw=H100)
        assert dict(lat.axes)["m"] == (64, 128, 256, 512)
        with pytest.raises(ValueError, match="no feasible"):
            BucketLattice.from_spec(
                matmul_spec(), {"m": (8, 512), "n": (256, 256),
                                "k": (512, 512)}, hw=H100)


# ---------------------------------------------------------------------------
# BucketedDispatch: the branch-index decision
# ---------------------------------------------------------------------------

_AXES = {"m": [64, 128, 256], "n": [256, 512]}
_SHAPES = {"m": [64, 64, 128, 128, 256], "n": [256, 512, 256, 512, 256]}
_CONFIGS = {"bm": [8, 8, 16, 16, 32], "bn": [128, 256, 128, 256, 128]}


def _hand_dispatch(ref: bool = False):
    """Lattice + hand-built plan table; bucket (256, 512) left unplanned
    so the in-range-but-unplanned miss path is reachable.  ``ref``: the
    JAX package's dispatch over the same table."""
    lat_cls, table_cls, disp_cls = ((RefLattice, RefTable, RefDispatch)
                                    if ref else
                                    (BucketLattice, LaunchPlanTable,
                                     BucketedDispatch))
    lat = lat_cls.from_axes("k", _AXES)
    table = table_cls.build(
        "k", V5E.name, ("m", "n"), ("bm", "bn"),
        {d: np.array(v) for d, v in _SHAPES.items()},
        {p: np.array(v) for p, v in _CONFIGS.items()})
    if ref:
        return disp_cls.build(lat, table, {"bm": 8, "bn": 128})
    return disp_cls.build(lat, table, {"bm": 8, "bn": 128}, device="cpu")


class TestBucketedDispatch:
    def test_static_config_set(self):
        disp = _hand_dispatch()
        # 5 planned rows, all distinct -> 5 configs + trailing default
        assert disp.configs == ((8, 128), (8, 256), (16, 128), (16, 256),
                                (32, 128))
        assert disp.n_branches == 6
        assert disp.config_dicts()[-1] == {"bm": 8, "bn": 128}
        assert len(disp.config_dicts()) == disp.n_branches
        ref = _hand_dispatch(ref=True)
        assert disp.configs == ref.configs
        assert disp.config_dicts() == ref.config_dicts()

    def test_graph_matches_host_on_all_paths(self):
        """``branch_index`` in torch ops equals ``host_index`` on every
        path, and both equal the JAX dispatch's jitted ``branch_index``."""
        disp, ref = _hand_dispatch(), _hand_dispatch(ref=True)

        @jax.jit
        def ref_decide(dims):
            return ref.branch_index(dims)

        cases = [
            {"m": 64, "n": 256},    # exact bucket hit
            {"m": 33, "n": 200},    # rounded-up hit
            {"m": 129, "n": 300},   # rounds to (256, 512): unplanned miss
            {"m": 256, "n": 512},   # unplanned bucket, exact
            {"m": 300, "n": 256},   # out of range (above top)
            {"m": 0, "n": 256},     # out of range (non-positive)
        ]
        for D in cases:
            idx, hit = disp.branch_index(D)
            assert idx.dtype == torch.int32 and hit.dtype == torch.bool
            h_idx, h_hit = disp.host_index(D)
            assert (int(idx), bool(hit)) == (h_idx, h_hit), D
            r_idx, r_hit = ref_decide(jnp.asarray([D["m"], D["n"]],
                                                  jnp.int32))
            assert (int(r_idx), bool(r_hit)) == (h_idx, h_hit), D
            # a tensor of raw dims decides the same
            t_idx, _ = disp.branch_index(torch.tensor([D["m"], D["n"]]))
            assert int(t_idx) == h_idx
        # hits resolve to a real branch, misses to the trailing default
        assert disp.host_index({"m": 64, "n": 256})[1] is True
        for D in cases[2:]:
            assert disp.host_index(D) == (len(disp.configs), False), D

    def test_host_config_matches_table(self):
        disp = _hand_dispatch()
        cfg, hit = disp.host_config({"m": 100, "n": 300})  # -> (128, 512)
        assert hit and cfg == {"bm": 16, "bn": 256}
        cfg, hit = disp.host_config({"m": 200, "n": 600})  # out of range
        assert not hit and cfg == {"bm": 8, "bn": 128}

    def test_observe_emits_bucket_events(self):
        disp = _hand_dispatch()
        events = []
        set_choice_listener(events.append)
        try:
            hit, waste = disp.observe({"m": 33, "n": 200}, n_coalesced=3)
            assert hit and waste == pytest.approx(
                disp.lattice.padding_waste({"m": 33, "n": 200}))
            miss_hit, miss_waste = disp.observe({"m": 999, "n": 256})
            assert not miss_hit and miss_waste == 0.0
        finally:
            set_choice_listener(None)
        assert [e.source for e in events] == ["bucket", "default"]
        assert events[0].n_coalesced == 3
        assert events[0].config == {"bm": 8, "bn": 128}
        assert events[1].config == {"bm": 8, "bn": 128}  # default branch
        assert events[0].kernel == "k" and events[0].hw_name == V5E.name

    def test_mismatched_params_rejected(self):
        lat = BucketLattice.from_axes("k", {"m": [64]})
        table = LaunchPlanTable.build(
            "k", V5E.name, ("m", "n"), ("bm",),
            {"m": np.array([64]), "n": np.array([256])},
            {"bm": np.array([8])})
        with pytest.raises(ValueError, match="do not match"):
            BucketedDispatch.build(lat, table, {"bm": 8}, device="cpu")

    def test_empty_table_always_defaults(self):
        lat = BucketLattice.from_axes("k", {"m": [64, 128]})
        table = LaunchPlanTable.build(
            "k", V5E.name, ("m",), ("bm",),
            {"m": np.zeros(0, dtype=np.int64)},
            {"bm": np.zeros(0, dtype=np.int64)})
        disp = BucketedDispatch.build(lat, table, {"bm": 32}, device="cpu")
        assert disp.n_branches == 1
        assert disp.host_index({"m": 64}) == (0, False)
        assert disp.host_config({"m": 64}) == ({"bm": 32}, False)
        idx, hit = disp.branch_index({"m": 64})
        assert (int(idx), bool(hit)) == (0, False)

    def test_tables_default_to_the_card(self, tmp_path, monkeypatch):
        """With no device given, the device table, the dispatch and the
        device rounding go to the card, as the port's entry points do:
        without one they raise instead of landing on the CPU."""
        monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path))
        registry.clear()
        lat = BucketLattice.from_axes("k", {"m": [64, 128]})
        table = LaunchPlanTable.build(
            "k", V5E.name, ("m",), ("bm",),
            {"m": np.array([64])}, {"bm": np.array([8])})
        mm_lat = BucketLattice.from_axes("matmul_b16", {
            "m": [64], "n": [256], "k": [256]})
        calls = (lambda: table.to_device(),
                 lambda: BucketedDispatch.build(lat, table, {"bm": 32}),
                 lambda: build_bucketed_dispatch("matmul_b16", mm_lat,
                                                 ops.MATMUL_DEFAULT),
                 lambda: lat.bucket_keys([100]))
        for call in calls:
            if torch.cuda.is_available():
                out = call()
                dev = (out.device if hasattr(out, "device")
                       else out.table.device if hasattr(out, "table")
                       else out[0].device)
                assert dev.type == "cuda"
            else:
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    call()
        # a tensor's own device wins over the default
        keys, _ = lat.bucket_keys(torch.tensor([100], dtype=torch.int32))
        assert keys.device.type == "cpu" and keys.tolist() == [128]

    def test_build_without_a_driver_takes_the_default(self, tmp_path,
                                                      monkeypatch):
        """``build_bucketed_dispatch`` with no registered driver: an empty
        table keyed on the registry's hardware name, every shape on the
        default branch."""
        monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path))
        registry.clear()
        lat = BucketLattice.from_axes("matmul_b16", {
            "m": [64, 128], "n": [256], "k": [256]})
        disp = build_bucketed_dispatch("matmul_b16", lat, ops.MATMUL_DEFAULT,
                                       device="cpu")
        assert disp.n_branches == 1 and len(disp.table) == 0
        assert disp.table.hw_name == registry.hw_name("matmul_b16")
        assert disp.host_config({"m": 100, "n": 256, "k": 256}) == \
            (ops.MATMUL_DEFAULT, False)


# ---------------------------------------------------------------------------
# The in-graph op path: one step per branch, many shapes
# ---------------------------------------------------------------------------

def _f32_matmul_dispatch():
    """A ``matmul_b32`` dispatch whose two planned buckets take two SIMT
    tiles; (256, 256, 256) is left unplanned, so it takes the default."""
    lat = BucketLattice.from_axes(
        "matmul_b32", {"m": [64, 128, 256], "n": [256], "k": [256]})
    table = LaunchPlanTable.build(
        "matmul_b32", H100.name, ("m", "n", "k"), ("bm", "bn", "bk"),
        {"m": np.array([64, 128]), "n": np.array([256, 256]),
         "k": np.array([256, 256])},
        {"bm": np.array([32, 64]), "bn": np.array([64, 128]),
         "bk": np.array([16, 32])})
    return BucketedDispatch.build(lat, table, ops.MATMUL_DEFAULT_F32,
                                  device="cpu")


def _flat_dispatch(kernel, axes, default):
    """A dispatch with an empty table: every raw shape on the default."""
    lat = BucketLattice.from_axes(kernel, axes)
    table = LaunchPlanTable.build(
        kernel, H100.name, tuple(axes), tuple(default),
        {d: np.zeros(0, dtype=np.int64) for d in axes},
        {p: np.zeros(0, dtype=np.int64) for p in default})
    return BucketedDispatch.build(lat, table, default, device="cpu")


class TestInGraphOps:
    def test_matmul_one_step_per_branch_many_shapes(self):
        disp = _f32_matmul_dispatch()
        env = disp.lattice.envelope_shape()
        M, N, K = env["m"], env["n"], env["k"]
        xp = torch.zeros(M, K)
        yp = torch.zeros(K, N)
        graphs = BranchGraphs(
            disp, lambda d: ops.matmul(xp, yp, in_graph=disp, dims=d), "cpu")
        rng = np.random.default_rng(0)
        shapes = [(40, 200, 200), (64, 256, 256), (100, 130, 250),
                  (128, 256, 256), (7, 9, 11), (200, 256, 100),
                  (256, 256, 256), (33, 17, 255)]
        branches = set()
        for (m, n, k) in shapes:
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32))
            y = torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32))
            xp.zero_()[:m, :k] = x
            yp.zero_()[:k, :n] = y
            D = {"m": m, "n": n, "k": k}
            out = graphs(D)
            assert out.shape == (M, N)
            torch.testing.assert_close(out[:m, :n], x @ y, rtol=F32_TOL,
                                       atol=F32_TOL)
            branches.add(disp.host_index(D)[0])
        # three branches taken (two planned tiles and the default), one
        # step object each, whatever the number of raw shapes
        assert branches == {0, 1, 2}
        assert graphs.captures == len(graphs.steps) == 3 <= disp.n_branches

    def test_matmul_launches_the_branch_config(self, monkeypatch):
        """The op launches the branch's config, fitted to the envelope, and
        makes no registry decision."""
        from repro_torch.kernels import ops as ops_mod

        disp = _f32_matmul_dispatch()
        seen = []
        real = ops_mod.matmul_kernel

        def spy(x, y, **kw):
            seen.append({k: kw[k] for k in ("bm", "bn", "bk")})
            return real(x, y, **kw)

        monkeypatch.setattr(ops_mod, "matmul_kernel", spy)
        monkeypatch.setattr(ops_mod, "choose_or_default",
                            lambda *a, **k: pytest.fail("registry asked"))
        xp, yp = torch.zeros(256, 256), torch.zeros(256, 256)
        for m, want in ((50, {"bm": 32, "bn": 64, "bk": 16}),
                        (100, {"bm": 64, "bn": 128, "bk": 32}),
                        (200, ops.MATMUL_DEFAULT_F32)):
            ops.matmul(xp, yp, in_graph=disp,
                       dims={"m": m, "n": 256, "k": 256})
            assert seen[-1] == want, m
        # dims default to the envelope
        ops.matmul(xp, yp, in_graph=disp)
        assert seen[-1] == ops.MATMUL_DEFAULT_F32

    def test_matmul_checks_its_operands(self):
        disp = _f32_matmul_dispatch()
        with pytest.raises(ValueError, match="2-D"):
            ops.matmul(torch.zeros(2, 64, 256), torch.zeros(256, 256),
                       in_graph=disp)
        with pytest.raises(ValueError, match="granule"):
            ops.matmul(torch.zeros(60, 256), torch.zeros(256, 256),
                       in_graph=disp)
        with pytest.raises(ValueError, match="cannot launch"):
            ops.matmul(torch.zeros(64, 256, dtype=torch.bfloat16),
                       torch.zeros(256, 256, dtype=torch.bfloat16),
                       in_graph=disp)

    def test_flash_in_graph_requires_causal(self):
        disp = _flat_dispatch("flash_attn_d64",
                              {"bh": [2], "sq": [8], "skv": [8]},
                              ops.FLASH_DEFAULT)
        q = torch.zeros(2, 8, 64)
        with pytest.raises(ValueError, match="causal"):
            ops.flash_attention(q, q, q, causal=False, num_q_heads=2,
                                num_kv_heads=2, in_graph=disp)

    def test_flash_layernorm_colsum_many_raw_shapes(self):
        """Causal flash, the layernorm and the column sum at 4 raw shapes
        each through one step per branch over padded buffers; the sliced
        outputs equal the plain versions on the raw inputs."""
        gen = torch.Generator().manual_seed(0)
        BH, SQ, d = 4, 64, 64
        fdisp = _flat_dispatch(
            "flash_attn_d64_causal",
            {"bh": [BH], "sq": [16, 32, 64], "skv": [16, 32, 64]},
            ops.FLASH_DEFAULT)
        qkv = [torch.zeros(BH, SQ, d) for _ in range(3)]
        flash = BranchGraphs(fdisp, lambda D: ops.flash_attention(
            *qkv, num_q_heads=BH, num_kv_heads=BH, causal=True,
            in_graph=fdisp, dims=D), "cpu")
        for s in (5, 16, 40, 64):
            raw = [torch.randn(BH, s, d, generator=gen) for _ in range(3)]
            for buf, t in zip(qkv, raw):
                buf.zero_()[:, :s] = t
            out = flash({"bh": BH, "sq": s, "skv": s})
            want = flash_attention_plain(*raw, num_q_heads=BH,
                                         num_kv_heads=BH, causal=True)
            torch.testing.assert_close(out[:, :s], want, rtol=F32_TOL,
                                       atol=F32_TOL)
        assert flash.captures == 1

        R, c = 128, 96
        ak = ops._layernorm_auto(c, 4, 1e-6, "cpu")
        ldisp = _flat_dispatch(ak.name, {"r": [32, 64, 128]}, ak.defaults)
        x, res = torch.zeros(R, c), torch.zeros(R, c)
        gamma, beta = torch.randn(c, generator=gen), torch.randn(
            c, generator=gen)
        ln = BranchGraphs(ldisp, lambda D: ops.layernorm(
            x, res, gamma, beta, in_graph=ldisp, dims=D), "cpu")
        for r in (1, 30, 77, 128):
            xr, rr = (torch.randn(r, c, generator=gen) for _ in range(2))
            x.zero_()[:r], res.zero_()[:r] = xr, rr
            out = ln({"r": r})
            assert out.shape == (R, c) and bool(torch.isfinite(out).all())
            torch.testing.assert_close(
                out[:r], layernorm_plain(xr, rr, gamma, beta, 1e-6),
                rtol=F32_TOL, atol=F32_TOL)
        assert ln.captures == 1

        cs_ak = ops._colsum_auto(4, "cpu")
        CR, CC = 256, 256
        cdisp = _flat_dispatch(cs_ak.name, {"r": [64, 256], "c": [128, 256]},
                               cs_ak.defaults)
        xc = torch.zeros(CR, CC)
        cs = BranchGraphs(cdisp, lambda D: ops.blocked_colsum(
            xc, in_graph=cdisp, dims=D), "cpu")
        for r, cc in ((3, 5), (64, 128), (100, 200), (256, 256)):
            xr = torch.randn(r, cc, generator=gen)
            xc.zero_()[:r, :cc] = xr
            out = cs({"r": r, "c": cc})
            assert out.shape == (CC,)
            torch.testing.assert_close(out[:cc], colsum_plain(xr),
                                       rtol=F32_TOL, atol=F32_TOL)
        assert cs.captures == 1
        with pytest.raises(ValueError, match="multiple"):
            ops.blocked_colsum(torch.zeros(8, 100), in_graph=cdisp)


# ---------------------------------------------------------------------------
# pow2 prefill chunking
# ---------------------------------------------------------------------------

class TestPow2Chunks:
    def test_exact_cover_and_bounds(self):
        for cmax in (1, 2, 8, 32, 64):
            allowed = {c for c in (1, 2, 4, 8, 16, 32, 64) if c <= cmax}
            for n in list(range(0, 70)) + [127, 128, 129, 1000]:
                chunks = ServingEngine._pow2_chunks(n, cmax)
                assert sum(chunks) == n, (n, cmax)
                assert all(c in allowed for c in chunks), (n, cmax)
                # descending, so at most one of each size below the cap:
                # the step-build bound log2(cmax)+1 plus repeats of cmax
                assert chunks == sorted(chunks, reverse=True), (n, cmax)
                below_cap = [c for c in chunks if c < cmax]
                assert len(below_cap) == len(set(below_cap)), (n, cmax)

    def test_trace_set_is_log_bounded(self):
        sizes = set()
        for n in range(1, 2000):
            sizes.update(ServingEngine._pow2_chunks(n, 64))
        assert sizes == {1, 2, 4, 8, 16, 32, 64}   # log2(64)+1 steps

    def test_equal_to_the_reference(self):
        for cmax in (0, 1, 2, 3, 8, 32, 64, 100):
            for n in list(range(0, 70)) + [127, 128, 129, 1000]:
                assert ServingEngine._pow2_chunks(n, cmax) == \
                    RefEngine._pow2_chunks(n, cmax), (n, cmax)
