"""The port's fault-tolerance hooks held against the JAX package's.

``repro_torch.distributed.fault_tolerance`` is the reference's
``repro.distributed.fault_tolerance`` (stdlib only), which the tuning farm
wires to its board's leases.  The reference's seven
``tests/test_distributed.py::TestFaultTolerance`` tests (all but its
pipeline-parallel ``test_bubble_fraction``) run here by name; then both
packages' ``Watchdog``, ``StragglerMonitor`` and ``retry_loop`` go through
the same scripted sequences and must end in the same states.  Timeouts
are 0.15-0.4 s with sleeps at least twice the watchdog's poll (a quarter
of its timeout) away from every deadline.
"""

import time

import pytest

from repro.distributed import fault_tolerance as ref_ft

from repro_torch.distributed import (FaultToleranceError, StragglerMonitor,
                                     Watchdog, retry_loop)


class TestFaultTolerance:
    def test_watchdog_fires(self):
        w = Watchdog(timeout_s=0.2).start()
        time.sleep(0.5)
        assert w.fired
        w.stop()

    def test_watchdog_beats_keep_alive(self):
        w = Watchdog(timeout_s=0.4).start()
        for _ in range(4):
            time.sleep(0.1)
            w.beat()
        assert not w.fired
        w.stop()

    def test_watchdog_fires_once_until_reset(self):
        fires = []
        w = Watchdog(timeout_s=0.15, on_timeout=lambda: fires.append(1))
        w.start()
        time.sleep(0.5)
        # fired exactly once despite several timeout windows elapsing
        assert w.fired and len(fires) == 1
        w.stop()

    def test_watchdog_rearms_after_reset(self):
        fires = []
        w = Watchdog(timeout_s=0.15, on_timeout=lambda: fires.append(1))
        w.start()
        time.sleep(0.4)
        assert w.fired and len(fires) == 1
        w.reset()               # re-arm: a revived worker is watchable again
        assert not w.fired
        time.sleep(0.1)
        assert not w.fired      # reset also refreshed the heartbeat
        time.sleep(0.4)
        assert w.fired and len(fires) == 2
        w.stop()

    def test_straggler_monitor(self):
        mon = StragglerMonitor(n_hosts=4, threshold=2.0, patience=2)
        assert mon.observe([1.0, 1.0, 1.0, 1.0]) == []
        assert mon.observe([1.0, 1.0, 1.0, 5.0]) == []
        assert mon.observe([1.0, 1.0, 1.0, 5.0]) == [3]

    def test_retry_loop_survives_failures(self):
        calls = {"n": 0}

        def run(start):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("boom")

        failures = retry_loop(run, restore_fn=lambda: 0, max_failures=5)
        assert failures == 2

    def test_retry_loop_gives_up(self):
        def run(start):
            raise RuntimeError("always")

        with pytest.raises(FaultToleranceError):
            retry_loop(run, restore_fn=lambda: 0, max_failures=2)


# -- both packages, the same scripts ------------------------------------------

def _watchdog_script(mod) -> list:
    """Fire, stay fired through beats, reset, stay quiet under beats, fire
    again: the state after each step."""
    fires = []
    w = mod.Watchdog(timeout_s=0.2, on_timeout=lambda: fires.append(1))
    w.start()
    states = []
    try:
        time.sleep(0.5)
        states.append((w.fired, len(fires)))
        w.beat()                    # a beat does not re-arm a fired dog
        time.sleep(0.1)
        states.append((w.fired, len(fires)))
        w.reset()
        states.append((w.fired, len(fires)))
        for _ in range(4):
            time.sleep(0.08)
            w.beat()
        states.append((w.fired, len(fires)))
        time.sleep(0.5)
        states.append((w.fired, len(fires)))
    finally:
        w.stop()
    return states


def test_watchdog_script_ends_in_the_reference_states():
    port = _watchdog_script(__import__("repro_torch.distributed",
                                       fromlist=["Watchdog"]))
    ref = _watchdog_script(ref_ft)
    assert port == ref == [(True, 1), (True, 1), (False, 1), (False, 1),
                           (True, 2)]


@pytest.mark.parametrize("threshold,patience", [(2.0, 2), (3.0, 3),
                                                (1.5, 1)])
def test_straggler_monitor_flags_as_the_reference(threshold, patience):
    """A seeded sequence of per-host step times (one slow host for a
    while, then another): the same flags after every step and the same
    strikes at the end."""
    import numpy as np

    rng = np.random.RandomState(0)
    steps = []
    for i in range(30):
        t = list(1.0 + 0.1 * rng.rand(5))
        if 5 <= i < 14:
            t[3] *= 4.0
        if 18 <= i < 25:
            t[1] *= 2.5
        steps.append(t)
    port = StragglerMonitor(n_hosts=5, threshold=threshold,
                            patience=patience)
    ref = ref_ft.StragglerMonitor(n_hosts=5, threshold=threshold,
                                  patience=patience)
    flags = [(port.observe(t), ref.observe(t)) for t in steps]
    assert all(p == r for p, r in flags)
    assert any(p for p, _ in flags)
    assert port._strikes == ref._strikes


@pytest.mark.parametrize("fail_first", [0, 1, 2, 4])
def test_retry_loop_counts_as_the_reference(fail_first):
    def script(mod):
        calls = {"n": 0, "starts": []}

        def run(start):
            calls["n"] += 1
            calls["starts"].append(start)
            if calls["n"] <= fail_first:
                raise RuntimeError("boom")

        try:
            out = mod.retry_loop(run, restore_fn=lambda: calls["n"] * 10,
                                 max_failures=3)
        except mod.FaultToleranceError as e:
            out = f"gave up: {e}"
        return out, calls["starts"]

    port = script(__import__("repro_torch.distributed.fault_tolerance",
                             fromlist=["retry_loop"]))
    assert port == script(ref_ft)
