"""The port's step plans and decision memo: a frozen per-step map of launch
configs, its generation rule, the ops' dispatch through it, and the memo in
front of ``choose_or_default``.

The classes mirror ``tests/test_step_plan.py``'s of the same names, with
drivers built on ``HopperModel`` on the CPU.  The last ones hold the port's
own hazards: its ops resolve at the granule-padded D, and a resolved config
may be shared, so no op may change it.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (H100, DriverProgram, HopperModel, Klaraptor,
                              choose_or_default, compile_plan, dkey,
                              flash_attention_spec, flash_probe_data,
                              gmm_probe_data, lattice, matmul_spec,
                              memo_key, moe_gmm_spec, register_driver,
                              registry, set_choice_listener,
                              set_decision_memo, ssd_probe_data,
                              ssd_scan_spec)
from repro_torch.core.step_plan import (KernelRequest, StepPlan,
                                        active_step_plan, build_step_plan,
                                        use_step_plan)
from repro_torch.kernels import ops
from repro_torch.launch import make_prefill_step
from repro_torch.models import Model
from repro_torch.models import transformer as T

SPECS = {
    "matmul": (matmul_spec, None),
    "flash": (flash_attention_spec, flash_probe_data),
    "moe": (moe_gmm_spec, gmm_probe_data),
    "ssd": (ssd_scan_spec, ssd_probe_data),
}

ENVELOPES = {
    "matmul": {"m": [512, 1024, 2048, 4096], "n": [512, 1024, 2048, 4096],
               "k": [512, 1024]},
    "flash": {"bh": [2, 8], "sq": [512, 1024, 2048, 4096],
              "skv": [1024, 2048]},
    "moe": {"e": [2, 8], "g": [256, 1024], "k": [512, 1024],
            "n": [512, 1024]},
    "ssd": {"bh": [2, 8], "s": [1024, 2048, 4096], "chunkflops": [1]},
}
D_IN = {"m": 1024, "n": 2048, "k": 512}
D_OUT = {"m": 192, "n": 384, "k": 640}      # off the lattice, kernel-valid
PINNED = {"bm": 64, "bn": 128, "bk": 64}


def _build(spec, probe=None, **kw):
    if probe is not None:
        kw.setdefault("probe_data", probe())
    return Klaraptor(HopperModel(noise=0.03, seed=7), device="cpu",
                     cache=False).build_driver(
        spec, repeats=2, max_configs_per_size=16, register=False, **kw)


@pytest.fixture(scope="module")
def builds():
    """One driver per hand-specced kernel, built once (not registered)."""
    return {name: _build(make(), probe)
            for name, (make, probe) in SPECS.items()}


@pytest.fixture()
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    set_choice_listener(None)
    yield
    registry.clear()
    set_choice_listener(None)


def _rows(driver, cols):
    n = next(iter(cols.values())).shape[0]
    return [{d: int(cols[d][i]) for d in driver.data_params}
            for i in range(n)]


# ---------------------------------------------------------------------------
# StepPlan: batched build, agreement with choose, generation rule
# ---------------------------------------------------------------------------

class TestStepPlan:
    def _requests(self, driver, cols, default=None):
        return [KernelRequest.make(driver.kernel, D, default or {"zz": -1})
                for D in _rows(driver, cols)]

    def test_build_matches_choose_bit_identical(self, clean, builds):
        """The batched sweep picks what choose() picks, for every kernel,
        in one build over all four."""
        for name in sorted(SPECS):
            register_driver(builds[name].driver)
        reqs = []
        for name in sorted(SPECS):
            reqs += self._requests(builds[name].driver,
                                   lattice(ENVELOPES[name]))
        plan = build_step_plan(reqs)
        assert plan.describe()["sources"] == {"driver": len(plan)}
        for name in sorted(SPECS):
            driver = builds[name].driver
            for D in _rows(driver, lattice(ENVELOPES[name])):
                driver.namespace["_HISTORY"].clear()
                assert plan.resolve(driver.kernel, D) == driver.choose(D), \
                    (name, D)

    def test_default_for_untuned_kernel(self, clean):
        plan = build_step_plan([KernelRequest.make(
            "nonexistent", {"m": 8}, {"bm": 128})])
        assert plan.resolve("nonexistent", {"m": 8}) == {"bm": 128}
        assert plan.describe()["sources"] == {"default": 1}

    def test_override_and_plan_outrank_driver_at_build(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        registry.register_plan(compile_plan(driver,
                                            lattice(ENVELOPES["matmul"])))
        D_pin = {"m": 512, "n": 512, "k": 512}
        registry.note_override(driver.kernel, H100.name, D_pin, PINNED)
        plan = build_step_plan([
            KernelRequest.make(driver.kernel, D, {"bm": -1})
            for D in (D_pin, D_IN, D_OUT)])
        assert plan.resolve(driver.kernel, D_pin) == PINNED
        src = plan.sources
        assert src[(driver.kernel, dkey(D_pin))] == "override"
        assert src[(driver.kernel, dkey(D_IN))] == "plan"
        assert src[(driver.kernel, dkey(D_OUT))] == "driver"

    def test_generation_bump_invalidates(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        plan = build_step_plan([KernelRequest.make(driver.kernel, D_IN,
                                                   {"bm": -1})])
        assert not plan.stale()
        assert plan.resolve(driver.kernel, D_IN) is not None
        registry.note_override(driver.kernel, H100.name, D_IN, PINNED)
        assert plan.stale()
        assert plan.resolve(driver.kernel, D_IN) is None

    def test_refit_hot_swap_invalidates(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        plan = build_step_plan([KernelRequest.make(driver.kernel, D_IN,
                                                   {"bm": -1})])
        registry.invalidate_kernel(driver.kernel)
        assert plan.stale() and plan.resolve(driver.kernel, D_IN) is None
        refit = DriverProgram.from_source(
            driver.kernel, driver.source + "\n# refit\n", driver.hw,
            tuning_version=1)
        register_driver(refit)
        assert plan.resolve(driver.kernel, D_IN) is None
        plan2 = build_step_plan([KernelRequest.make(driver.kernel, D_IN,
                                                    {"bm": -1})])
        assert plan2.resolve(driver.kernel, D_IN) == refit.choose(D_IN)

    def test_mid_build_mutation_births_stale_plan(self, clean, builds):
        """A plan stamped with an earlier generation serves nothing."""
        driver = builds["matmul"].driver
        register_driver(driver)
        gen = registry.generation
        plan = build_step_plan([KernelRequest.make(driver.kernel, D_IN,
                                                   {"bm": -1})])
        assert plan.generation == gen
        stale = StepPlan(hw_name=plan.hw_name, generation=gen - 1,
                         table=plan.table, sources=plan.sources)
        assert stale.resolve(driver.kernel, D_IN) is None


# ---------------------------------------------------------------------------
# Ops: the plan context, its precedence, no registry traffic on a hit
# ---------------------------------------------------------------------------

F32_TILES = {"bm": 8, "bn": 128, "bk": 128}


class TestOpsDispatch:
    def test_context_and_explicit_plan(self, clean):
        D = {"m": 64, "n": 64, "k": 64}
        plan = build_step_plan([KernelRequest.make("matmul_b32", D,
                                                   F32_TILES)])
        assert active_step_plan() is None
        with use_step_plan(plan):
            assert active_step_plan() is plan
            got = ops._resolve("matmul_b32", D, ops.MATMUL_DEFAULT_F32, None)
            assert got == F32_TILES
            with use_step_plan(None):      # an inner plan switched off
                assert active_step_plan() is None
        assert active_step_plan() is None
        got = ops._resolve("matmul_b32", D, ops.MATMUL_DEFAULT_F32, plan)
        assert got == F32_TILES

    def test_plan_hit_makes_no_registry_traffic(self, clean):
        D = {"m": 64, "n": 64, "k": 64}
        plan = build_step_plan([KernelRequest.make("matmul_b32", D,
                                                   F32_TILES)])
        events = []
        set_choice_listener(events.append)
        before = registry.stats()
        with use_step_plan(plan):
            ops._resolve("matmul_b32", D, ops.MATMUL_DEFAULT_F32, None)
        assert events == []
        assert registry.stats() == before

    def test_pinned_override_outranks_step_plan(self, clean):
        """A fresh override beats a frozen plan: pinning it stales the
        plan, and choose_or_default serves the pin."""
        D = {"m": 64, "n": 64, "k": 64}
        plan = build_step_plan([KernelRequest.make(
            "matmul_b32", D, {"bm": 256, "bn": 256, "bk": 256})])
        registry.note_override("matmul_b32", H100.name, D, F32_TILES)
        with use_step_plan(plan):
            assert ops._resolve("matmul_b32", D, ops.MATMUL_DEFAULT_F32,
                                None) == F32_TILES

    def test_step_plan_outranks_registry_driver(self, clean, builds):
        driver = builds["matmul"].driver          # "matmul_b16"
        register_driver(driver)
        plan = StepPlan(hw_name=H100.name, generation=registry.generation,
                        table={(driver.kernel, dkey(D_IN)): PINNED},
                        sources={(driver.kernel, dkey(D_IN)): "test"})
        with use_step_plan(plan):
            assert ops._resolve(driver.kernel, D_IN, ops.MATMUL_DEFAULT,
                                None) == PINNED
        assert ops._resolve(driver.kernel, D_IN, ops.MATMUL_DEFAULT,
                            None) != PINNED

    def test_op_runs_under_step_plan(self, clean):
        D = {"m": 16, "n": 128, "k": 128}
        plan = build_step_plan([KernelRequest.make("matmul_b32", D,
                                                   F32_TILES)])
        x = torch.ones(16, 128)
        y = torch.ones(128, 128)
        events = []
        set_choice_listener(events.append)
        with use_step_plan(plan):
            out = ops.matmul(x, y)
        assert out.shape == (16, 128)
        torch.testing.assert_close(out, torch.full((16, 128), 128.0))
        assert events == []                 # decided by the plan


# ---------------------------------------------------------------------------
# The decision memo: identity of repeats, invalidation, listener accounting
# ---------------------------------------------------------------------------

class TestDecisionMemo:
    def test_repeat_is_bit_identical_and_memoized(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        first = choose_or_default(driver.kernel, D_IN, {"bm": -1})
        ent = registry.memo_get(memo_key(driver.kernel, H100.name, D_IN))
        assert ent is not None and ent[1] == "driver"
        second = choose_or_default(driver.kernel, D_IN, {"bm": -1})
        third = choose_or_default(driver.kernel, D_IN, {"bm": -1})
        assert second == first
        # hits share the entry's own copy, never the slow path's result
        assert second is not first and second is third
        assert registry.memo_hits() == 2

    def test_generation_bump_drops_memo(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        choose_or_default(driver.kernel, D_IN, {"bm": -1})
        registry.note_override(driver.kernel, H100.name, D_IN, PINNED)
        assert registry.memo_get(
            memo_key(driver.kernel, H100.name, D_IN)) is None
        assert choose_or_default(driver.kernel, D_IN, {"bm": -1}) == PINNED

    def test_default_path_not_memoized(self, clean):
        cfg = choose_or_default("untuned_kernel", {"m": 8}, {"bm": 64})
        assert cfg == {"bm": 64}
        assert registry.memo_get(
            memo_key("untuned_kernel", H100.name, {"m": 8})) is None
        assert choose_or_default("untuned_kernel", {"m": 8},
                                 {"bm": 32}) == {"bm": 32}

    def test_no_estimate_without_listener(self, clean, builds):
        """A memo hit with no listener pays no estimate()."""
        driver = builds["matmul"].driver
        register_driver(driver)
        calls = {"n": 0}
        inner = driver.namespace["estimate"]

        def counting(**kw):
            calls["n"] += 1
            return inner(**kw)

        driver.namespace["estimate"] = counting
        try:
            choose_or_default(driver.kernel, D_IN, {"bm": -1})
            baseline = calls["n"]
            for _ in range(5):
                choose_or_default(driver.kernel, D_IN, {"bm": -1})
            assert calls["n"] == baseline
            set_choice_listener(lambda e: None)
            choose_or_default(driver.kernel, D_IN, {"bm": -1})
            assert calls["n"] == baseline + 1
        finally:
            driver.namespace["estimate"] = inner

    def test_full_window_then_coalesced_events(self, clean, builds):
        from repro_torch.core.driver import (MEMO_FULL_WINDOW,
                                             MEMO_NOTIFY_EVERY)
        driver = builds["matmul"].driver
        register_driver(driver)
        events = []
        set_choice_listener(events.append)
        total = 1 + MEMO_FULL_WINDOW + MEMO_NOTIFY_EVERY
        for _ in range(total):
            choose_or_default(driver.kernel, D_IN, {"bm": -1})
        assert len(events) == 1 + MEMO_FULL_WINDOW + 1
        window = events[:1 + MEMO_FULL_WINDOW]
        assert all(e.n_coalesced == 1 and e.source == "driver"
                   and e.predicted_s is not None for e in window)
        assert events[-1].n_coalesced == MEMO_NOTIFY_EVERY
        assert sum(e.n_coalesced for e in events) == total

    def test_disable_enable(self, clean, builds):
        driver = builds["matmul"].driver
        register_driver(driver)
        prev = set_decision_memo(False)
        try:
            choose_or_default(driver.kernel, D_IN, {"bm": -1})
            assert registry.memo_get(
                memo_key(driver.kernel, H100.name, D_IN)) is None
        finally:
            set_decision_memo(prev)
        choose_or_default(driver.kernel, D_IN, {"bm": -1})
        assert registry.memo_get(
            memo_key(driver.kernel, H100.name, D_IN)) is not None


# ---------------------------------------------------------------------------
# DevicePlanTable: the on-device form of a plan (core/device_plan.py)
# ---------------------------------------------------------------------------

def _device_row(dev, D):
    """``dev.lookup`` (torch ops) at D, as ``lookup_dims`` returns it."""
    row, found = dev.lookup([D[d] for d in dev.data_params])
    if not bool(found):
        return None
    return dict(zip(dev.program_params, row.tolist()))


class TestDevicePlanTable:
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_bit_identical_hits_and_misses(self, builds, name):
        """The host probe (``lookup_dims``) and the device probe
        (``lookup``, torch ops) give the source table's config for every
        shape, hit or miss."""
        driver = builds[name].driver
        cols = lattice(ENVELOPES[name])
        table = compile_plan(driver, cols)
        dev = table.to_device("cpu")
        assert len(dev) == len(table)
        # every envelope point: identical config dict (hit for hit)
        for D in _rows(driver, cols):
            assert dev.lookup_dims(D) == table.lookup(D), (name, D)
            assert _device_row(dev, D) == table.lookup(D), (name, D)
            off = {d: v + 3 for d, v in D.items()}
            assert _device_row(dev, off) == dev.lookup_dims(off) \
                == table.lookup(off), (name, off)
        # misses: perturbed shapes, missing data params, extra keys ignored
        some = _rows(driver, cols)[0]
        off = {d: v + 1 for d, v in some.items()}
        assert dev.lookup_dims(off) == table.lookup(off)
        partial = dict(list(some.items())[:-1])
        assert dev.lookup_dims(partial) is None \
            and table.lookup(partial) is None
        extra = {**some, "zzz": 1}
        assert dev.lookup_dims(extra) == table.lookup(extra)

    def test_device_lookup_is_torch_ops(self, builds):
        """``lookup`` takes a key tensor and returns tensors on the table's
        device (no host value read): the row and the hit flag."""
        driver = builds["matmul"].driver
        table = compile_plan(driver, lattice(ENVELOPES["matmul"]))
        dev = table.to_device("cpu")
        row, found = dev.lookup(torch.tensor([1024, 2048, 512],
                                             dtype=torch.int32))
        assert row.dtype == torch.int32 and found.dtype == torch.bool
        assert bool(found)
        assert dict(zip(dev.program_params, row.tolist())) == \
            table.lookup({"m": 1024, "n": 2048, "k": 512})
        row, found = dev.lookup([999, 2048, 512])
        assert not bool(found) and row.tolist() == [-1, -1, -1]

    def test_pack_shape32_matches_reference(self):
        """The host hash and the torch hash chain equal the JAX package's
        ``pack_shape32`` over a sweep of shapes, signs and arities."""
        import numpy as np
        from repro.core.device_plan import pack_shape32 as ref_pack

        from repro_torch.core import pack_shape32
        from repro_torch.core.device_plan import _pack_shape32_t

        rng = np.random.default_rng(0)
        keys = [(), (0,), (1, 2, 3), (2**31 - 1, -2**31, -1)]
        keys += [tuple(int(v) for v in rng.integers(
            -2**31, 2**31 - 1, size=int(rng.integers(1, 5))))
            for _ in range(500)]
        for key in keys:
            want = ref_pack(key)
            assert pack_shape32(key) == want, key
            got = _pack_shape32_t(torch.tensor(key, dtype=torch.int32))
            assert int(got) == want, key

    def test_empty_table(self):
        from repro_torch.core import LaunchPlanTable

        empty = LaunchPlanTable.build(
            "k", H100.name, ("m",), ("bm",), {"m": []}, {"bm": []})
        dev = empty.to_device("cpu")
        assert len(dev) == 0 and dev.max_probe == 0
        assert dev.lookup_dims({"m": 64}) is None


# ---------------------------------------------------------------------------
# The port's hazards: padded keys, shared configs, a model step
# ---------------------------------------------------------------------------

class TestPaddedKeys:
    def test_padded_request_hits_for_an_unaligned_matmul(self, clean,
                                                         builds):
        """``ops.matmul`` resolves at the shape padded to the bf16 granule;
        a request built with ``ops.gemm_dims`` hits there, one built at the
        raw shape misses and falls through to the registry."""
        driver = builds["matmul"].driver
        register_driver(driver)
        raw = {"m": 100, "n": 200, "k": 300}
        padded = ops.gemm_dims("matmul_b16", raw)
        assert padded == {"m": 128, "n": 256, "k": 320}
        x = torch.randn(100, 300).to(torch.bfloat16)
        y = torch.randn(300, 200).to(torch.bfloat16)
        want = ops.matmul(x, y)
        events = []
        set_choice_listener(events.append)
        hit = build_step_plan([KernelRequest.make("matmul_b16", padded,
                                                  ops.MATMUL_DEFAULT)])
        assert hit.describe()["sources"] == {"driver": 1}
        stats, memo = registry.stats(), registry.memo_size()
        with use_step_plan(hit):
            got = ops.matmul(x, y)
        assert events == [] and registry.stats() == stats
        assert registry.memo_size() == memo
        assert torch.equal(got, want)
        miss = build_step_plan([KernelRequest.make("matmul_b16", raw,
                                                   ops.MATMUL_DEFAULT)])
        with use_step_plan(miss):
            ops.matmul(x, y)
        assert [e.source for e in events] == ["driver"]

    def test_moe_gmm_dims_are_its_padded_shape(self):
        assert ops.gemm_dims("moe_gmm_b16",
                             {"e": 3, "g": 100, "k": 300, "n": 200}) == \
            {"e": 3, "g": 128, "k": 320, "n": 256}
        assert ops.gemm_dims("matmul_b32", {"m": 9, "n": 16, "k": 1}) == \
            {"m": 16, "n": 16, "k": 8}


def _op_calls():
    """(name, kernel, D, config, call) for every op that resolves on the
    CPU, at the D it resolves at."""
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    bf = torch.bfloat16
    x, y = randn(100, 300, dtype=bf), randn(300, 200, dtype=bf)
    xg, wg = randn(2, 100, 300, dtype=bf), randn(2, 300, 200, dtype=bf)
    xs, dt = randn(4, 40, 16), torch.rand(4, 40, generator=gen) * 0.1
    Bs, Cs, A = randn(4, 40, 8), randn(4, 40, 8), -torch.rand(4) - 0.5
    xl, res, g, b = randn(40, 64), randn(40, 64), randn(64), randn(64)
    ln = ops._layernorm_auto(64, 4, 1e-6, "cpu")
    cs = ops._colsum_auto(4, "cpu")
    return [
        ("matmul", "matmul_b16", {"m": 128, "n": 256, "k": 320},
         {"bm": 128, "bn": 128, "bk": 64},
         lambda plan: ops.matmul(x, y, plan=plan)),
        ("moe_gmm", "moe_gmm_b16", {"e": 2, "g": 128, "k": 320, "n": 256},
         {"bg": 128, "bn": 128, "bk": 64},
         lambda plan: ops.moe_gmm(xg, wg, plan=plan)),
        ("ssd_scan", "ssd_scan_h16_n8", {"bh": 4, "s": 40, "chunkflops": 1},
         {"chunk": 32},
         lambda plan: ops.ssd_scan(xs, dt, Bs, Cs, A, plan=plan)),
        ("layernorm", ln.name, {"r": 40}, {"br": 16},
         lambda plan: ops.layernorm(xl, res, g, b, plan=plan)),
        ("blocked_colsum", cs.name, {"r": 40, "c": 64}, {"br": 16, "bc": 32},
         lambda plan: ops.blocked_colsum(xl, plan=plan)),
    ]


class TestSharedConfigs:
    @pytest.mark.parametrize("which", range(5), ids=[
        "matmul", "moe_gmm", "ssd_scan", "layernorm", "blocked_colsum"])
    def test_ops_leave_a_memoized_config_unchanged(self, clean, which):
        """The memo and a step plan hand the ops shared config dicts: after
        each op launched with one, it is unchanged."""
        _, kernel, D, cfg, call = _op_calls()[which]
        registry.note_override(kernel, H100.name, D, cfg)
        first = call(None)                          # memoized here
        ent = registry.memo_get(memo_key(kernel, H100.name, D))
        assert ent is not None and ent[1] == "override"
        shared = ent[0]
        second = call(None)                         # served by the memo
        assert registry.memo_hits() == 1
        assert shared == cfg and ent[0] is shared
        torch.testing.assert_close(second, first, rtol=0, atol=0)
        plan = build_step_plan([KernelRequest.make(kernel, D, {"x": -1})])
        entry = plan.table[(kernel, dkey(D))]
        call(plan)
        assert entry == cfg and plan.table[(kernel, dkey(D))] is entry


@pytest.fixture(scope="module")
def smoke_mamba():
    cfg = get_config("mamba2-130m", smoke=True).replace(dtype=torch.float32)
    spec = ssd_scan_spec(cfg.mamba_head_dim, cfg.ssm_state, 4)
    build = _build(spec, ssd_probe_data)
    return cfg, build.driver


def test_mamba_prefill_under_a_step_plan(clean, smoke_mamba):
    """The smoke mamba's prefill on the CPU (its SSD resolves its chunk
    there) under a step plan from ``decode_kernel_requests``: the registry
    is not touched, and the logits are the bits of the same step resolved
    through the registry."""
    cfg, driver = smoke_mamba
    register_driver(driver)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    S = 48
    tokens = torch.randint(0, cfg.vocab_size, (1, S),
                           generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(model)
    want = step(params, tokens)
    reqs = T.decode_kernel_requests(cfg, batch=1, max_seq=S, seqs=(S,))
    plan = build_step_plan(reqs)
    assert plan.describe()["sources"] == {"driver": 1}
    stats, memo = registry.stats(), registry.memo_size()
    hits = registry.memo_hits()
    events = []
    set_choice_listener(events.append)
    with use_step_plan(plan):
        got = step(params, tokens)
    assert events == [] and registry.stats() == stats
    assert registry.memo_size() == memo and registry.memo_hits() == hits
    assert torch.equal(got, want)
