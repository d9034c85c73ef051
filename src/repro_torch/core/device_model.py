"""Hardware parameters H and the device oracles for an NVIDIA Hopper card.

The paper fixes a target device, collects its hardware parameters from
vendor tables, and treats the device as an opaque oracle that its
CUPTI-based profiler probes.  Here the target is an H100 (compute
capability 9.0) and there are two oracles behind one interface
(``DeviceModel.probe_batch`` / ``true_time_batch``):

* ``CudaEventTimer`` -- the real oracle, in the role the paper gives CUPTI.
  It launches the port's own kernel at each row's (D, P) on the card and
  times it with ``torch.cuda.Event``: a warm-up, then N timed launches
  whose median the collector keeps.
* ``HopperModel`` -- an analytic stand-in for the card, used by the CPU
  tests.  Roofline time per CTA iteration times CTA waves, occupancy from
  ``cuda_occupancy_program``, plus hidden effects the fitter never sees
  (tile-size-dependent load efficiency, warp-count latency hiding, a
  per-iteration barrier bubble, an L2/DRAM floor, launch overhead) and
  seeded lognormal noise.

Splitting a CUDA-event total into memory and compute time
---------------------------------------------------------
The fit wants three metrics per probe (``mem_step``, ``cmp_step``,
``ovh_step``; see core/collect.py), but a pair of CUDA events gives one
total.  ``CudaEventTimer`` splits each measured total by the row's analytic
roofline ratio::

    t_mem = sum over operands of tile_bytes * fetches / hbm_bw
    t_cmp = flops / peak_flops(compute_unit)
    mem_time = total * t_mem / (t_mem + t_cmp)
    compute_time = total - mem_time

The compute peak is that of the unit the kernel's arithmetic runs on, which
its spec states (``KernelSpec.compute_unit``, carried by the traffic
table).  The bf16 matmul and grouped matmul, bf16 flash attention at head
dims 64, 128 and 256 and the bf16 SSD scan at (64, 128) run wgmma on the tensor
cores, so their rows take ``peak_flops_bf16``.  Every other kernel does its
FLOPs as FP32 FMAs on the CUDA cores -- the f32 matmul's micro-tile
products, the SIMT flash attention and SSD bodies (exp and tanh run on the
special function units and are not counted as FLOPs), the layernorm and the
column sum -- so their rows take ``peak_flops_f32``.  The bytes are the spec's operand traffic: for flash
attention a Q tile and an output tile per CTA and a K and a V tile per loop
iteration.  The split only labels the measured time: the perf model
recombines the fitted parts, so what the rule decides is which of the two
fits carries the measured variation.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, fields, replace
from typing import Callable, Mapping

import numpy as np
import torch

from .card_lock import CardLock

__all__ = [
    "HardwareParams", "H100", "ProbeBatch", "RowProbe", "DeviceModel",
    "TrafficOperand", "TrafficTable", "HopperModel", "CudaEventTimer",
    "kernel_sources_digest", "resolve_device", "roofline_times",
]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    return device


@dataclass(frozen=True)
class HardwareParams:
    """Hardware parameters H (paper Section II) of one CUDA device."""

    name: str
    sm_count: int
    regs_per_sm: int = 65536
    max_regs_per_thread: int = 255
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    max_threads_per_block: int = 1024
    smem_per_block_optin: int = 232448     # bytes, dynamic, opt-in above 48 KB
    smem_per_sm: int = 233472              # bytes
    smem_reserved_per_block: int = 1024    # bytes the runtime keeps per CTA
    warp_size: int = 32
    peak_flops_bf16: float = 989e12        # tensor cores, dense
    peak_flops_f32: float = 67e12          # FP32 FMA on the CUDA cores
    hbm_bw: float = 3.35e12                # bytes/s
    l2_bytes: int = 50 * 2**20

    @property
    def max_warps_per_sm(self) -> int:
        return self.max_threads_per_sm // self.warp_size

    def peak_flops(self, unit: str) -> float:
        """Peak FLOP/s of a compute unit: "bf16" (tensor cores) or "f32"
        (FMAs on the CUDA cores)."""
        if unit == "bf16":
            return self.peak_flops_bf16
        if unit == "f32":
            return self.peak_flops_f32
        raise ValueError(f"no peak for compute unit {unit!r}")

    @classmethod
    def from_device(cls, device: str | torch.device = "cuda"
                    ) -> "HardwareParams":
        """The card's parameters; the compute-capability-9.0 table for CPU.

        On a CUDA device the SM count, registers and threads per SM, warp
        size, L2 size and shared memory per SM and per block come from
        ``torch.cuda`` at run time; the limits PyTorch does not report
        (registers per thread, blocks per SM, threads per block) come from
        the 9.0 table, so any other compute capability is refused.  Only a
        caller that asks for ``cpu`` gets the table alone.
        """
        device = torch.device(device)
        if device.type == "cpu":
            return H100
        if device.type != "cuda":
            raise ValueError(f"no hardware table for device {device}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to use the "
                "compute-capability-9.0 table")
        props = torch.cuda.get_device_properties(device)
        if (props.major, props.minor) != (9, 0):
            raise RuntimeError(
                f"{props.name} has compute capability "
                f"{props.major}.{props.minor}; the port targets 9.0 (sm_90a)")
        return replace(
            H100,
            name=props.name,
            sm_count=props.multi_processor_count,
            regs_per_sm=props.regs_per_multiprocessor,
            max_threads_per_sm=props.max_threads_per_multi_processor,
            smem_per_block_optin=props.shared_memory_per_block_optin,
            smem_per_sm=props.shared_memory_per_multiprocessor,
            warp_size=props.warp_size,
            l2_bytes=props.L2_cache_size,
        )


# The compute-capability-9.0 table (H100 SXM: 132 SMs).
H100 = HardwareParams(name="h100_sxm_cc90", sm_count=132)


@dataclass
class ProbeBatch:
    """Struct-of-arrays probe results for a whole candidate table.

    Timing fields have shape ``(repeats, n_configs)``; the per-config
    workload descriptors have shape ``(n_configs,)``.
    """

    total_time_s: np.ndarray
    mem_time_s: np.ndarray
    compute_time_s: np.ndarray
    grid_steps: np.ndarray
    stage_bytes: np.ndarray
    blocks_resident: np.ndarray

    @property
    def n_executions(self) -> int:
        return int(self.total_time_s.size)


@dataclass
class RowProbe:
    """Per-row probe summary when every row may use a different repeat count.

    Timing fields are (n,) medians over each row's own repeats;
    ``device_seconds`` is the device time spent on each row (sum over its
    executions), which is what a ``SearchBudget`` charges.
    """

    total_time_s: np.ndarray
    mem_time_s: np.ndarray
    compute_time_s: np.ndarray
    grid_steps: np.ndarray
    stage_bytes: np.ndarray
    blocks_resident: np.ndarray
    device_seconds: np.ndarray
    repeats: np.ndarray

    @property
    def n_executions(self) -> int:
        return int(np.sum(self.repeats))


@dataclass
class TrafficOperand:
    """Columnar per-operand traffic for a whole candidate table.

    ``shapes`` is (n_configs, ndim): one tile shape per config.  ``fetches``
    is (n_configs,): how many times the tile crosses from device memory
    (through L2) into an SM over the whole launch.
    """

    name: str
    shapes: np.ndarray
    fetches: np.ndarray
    dtype_bytes: int
    is_output: bool

    def bytes(self) -> np.ndarray:
        tile = np.prod(np.asarray(self.shapes, dtype=np.float64), axis=1)
        return tile * self.dtype_bytes * np.asarray(self.fetches,
                                                    dtype=np.float64)


@dataclass
class TrafficTable:
    """Analytic workload of one kernel at one data size D over ``n`` configs.

    Carries D and the config columns it was built from, so a real timer can
    launch the kernel at each row, beside the derived launch geometry that
    the analytic oracle and the collector read.  Every field but ``kernel``
    and ``D`` is an (n,) array over the config axis.
    """

    kernel: str
    D: dict
    config: dict                  # program param -> (n,) int64
    ctas: np.ndarray              # thread blocks in the grid
    seq_iters: np.ndarray         # iterations of the loop inside a block
    threads: np.ndarray           # threads per block
    stage_bytes: np.ndarray       # shared memory per block (staged tiles)
    blocks_per_sm: np.ndarray     # B_active from the occupancy program
    blocks_resident: np.ndarray   # blocks per SM in one wave
    grid_steps: np.ndarray        # waves * seq_iters
    flops_total: np.ndarray
    operands: list
    compute_unit: str = "f32"     # the unit the FLOPs run on (peak_flops)

    def __len__(self) -> int:
        return int(self.grid_steps.shape[0])

    def select(self, index) -> "TrafficTable":
        """New table keeping rows selected by a boolean mask or index array."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = v[index]
            kw[f.name] = v
        kw["config"] = {p: c[index] for p, c in self.config.items()}
        kw["operands"] = [replace(op, shapes=op.shapes[index],
                                  fetches=op.fetches[index])
                          for op in self.operands]
        return TrafficTable(**kw)


def roofline_times(table: TrafficTable, hw: HardwareParams
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(t_mem, t_cmp) per row: operand traffic over the memory rate and
    FLOPs over the peak of the unit the kernel computes on -- the split
    rule's two parts."""
    mem_bytes = sum(op.bytes() for op in table.operands)
    t_mem = np.asarray(mem_bytes, dtype=np.float64) / hw.hbm_bw
    t_cmp = np.asarray(table.flops_total, dtype=np.float64) / \
        hw.peak_flops(table.compute_unit)
    return t_mem, t_cmp


class DeviceModel:
    """Opaque device oracle interface (what CUPTI + GPU are in the paper)."""

    hw: HardwareParams

    def fingerprint(self) -> dict:
        """JSON-able identity of this oracle."""
        return {"class": type(self).__name__}

    def probe_batch(self, table: TrafficTable, rng: np.random.RandomState,
                    repeats: int = 1) -> ProbeBatch:
        """Probe every launch in ``table`` ``repeats`` times."""
        raise NotImplementedError

    def probe_rows(self, table: TrafficTable, rng: np.random.RandomState,
                   repeats: np.ndarray | int = 1) -> RowProbe:
        """Probe row ``i`` of ``table`` ``repeats[i]`` times (medians per row).

        Rows are grouped by repeat count and each group goes through
        ``probe_batch``, so vectorized oracles stay vectorized.
        """
        n = len(table)
        reps = np.maximum(
            np.broadcast_to(np.asarray(repeats, dtype=np.int64), (n,)), 1)
        tot = np.empty(n)
        mem = np.empty(n)
        cmp_ = np.empty(n)
        spent = np.empty(n)
        for r in np.unique(reps):
            idx = np.flatnonzero(reps == r)
            batch = self.probe_batch(table.select(idx), rng, repeats=int(r))
            tot[idx] = np.median(batch.total_time_s, axis=0)
            mem[idx] = np.median(batch.mem_time_s, axis=0)
            cmp_[idx] = np.median(batch.compute_time_s, axis=0)
            spent[idx] = np.sum(batch.total_time_s, axis=0)
        return RowProbe(
            total_time_s=tot,
            mem_time_s=mem,
            compute_time_s=cmp_,
            grid_steps=np.asarray(table.grid_steps),
            stage_bytes=np.asarray(table.stage_bytes),
            blocks_resident=np.asarray(table.blocks_resident),
            device_seconds=spent,
            repeats=np.array(reps),
        )

    def true_time_batch(self, table: TrafficTable) -> np.ndarray:
        """Best estimate of each row's execution time (evaluation only)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no batched time oracle")


class HopperModel(DeviceModel):
    """Analytic stand-in for an H100, vectorized over the traffic table.

    Hidden physics (all invisible to the fitter):
      * tiles move from L2 into an SM at a per-SM share of the L2 rate, with
        an efficiency that ramps with the bytes a block loads per iteration
        (eff = 0.9 * s / (s + 8 KiB): small loads are latency-bound);
      * arithmetic throughput is a per-SM share of the peak of the unit the
        kernel computes on (tensor cores for the bf16 matmuls, FP32 FMAs
        otherwise), scaled by how many warps the SM holds to hide latency
        (saturating at 16 warps);
      * every iteration of the loop inside a block pays a barrier and load
        latency bubble of 0.8 us, which co-resident blocks hide;
      * with >= 2 blocks resident per SM one block's loads overlap another's
        FMAs, imperfectly (10% leak); with one block they serialize;
      * device memory is a floor: re-read tiles hit L2 85% of the time;
      * a fixed 3 us launch cost, and lognormal noise on every probe.
    """

    L2_BW_FACTOR = 2.5        # L2 -> SM rate relative to device memory
    LOAD_HALF_BYTES = 8192.0
    ITER_BUBBLE_S = 0.8e-6
    LAUNCH_S = 3e-6
    L2_MISS = 0.15

    def __init__(self, hw: HardwareParams = H100, noise: float = 0.04,
                 seed: int = 0):
        self.hw = hw
        self.noise = noise
        self._seed = seed

    def fingerprint(self) -> dict:
        return {"class": type(self).__name__, "hw": self.hw.name,
                "noise": self.noise, "seed": self._seed}

    def _times(self, t: TrafficTable
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        hw = self.hw
        sm = float(hw.sm_count)
        block_iters = np.maximum(
            np.asarray(t.ctas, dtype=np.float64)
            * np.asarray(t.seq_iters, dtype=np.float64), 1.0)
        in_bytes = sum((op.bytes() for op in t.operands if not op.is_output),
                       np.zeros(len(t)))
        out_bytes = sum((op.bytes() for op in t.operands if op.is_output),
                        np.zeros(len(t)))
        # One block's work in one iteration of its loop.
        load = in_bytes / block_iters
        flops = np.asarray(t.flops_total, dtype=np.float64) / block_iters
        eff_load = 0.9 * load / (load + self.LOAD_HALF_BYTES)
        m = load / (hw.hbm_bw * self.L2_BW_FACTOR / sm * eff_load)
        res = np.maximum(np.asarray(t.blocks_resident, dtype=np.float64), 1.0)
        warps = res * np.asarray(t.threads, dtype=np.float64) / hw.warp_size
        eff_cmp = 0.6 * np.minimum(warps / 16.0, 1.0)
        c = flops / (hw.peak_flops(t.compute_unit) / sm * eff_cmp)
        overlapped = res * (np.maximum(m, c) + 0.1 * np.minimum(m, c)) \
            + self.ITER_BUBBLE_S / res
        serialized = m + c + self.ITER_BUBBLE_S
        per_step = np.where(res >= 2, overlapped, serialized)
        steps = np.asarray(t.grid_steps, dtype=np.float64)
        dram = (in_bytes * self.L2_MISS + out_bytes) / hw.hbm_bw
        total = np.maximum(steps * per_step, dram) \
            + out_bytes / hw.hbm_bw + self.LAUNCH_S
        return total, steps * res * m, steps * res * c

    def probe_batch(self, table: TrafficTable,
                    rng: np.random.RandomState | None = None,
                    repeats: int = 1) -> ProbeBatch:
        """One ndarray pass over the whole table, then lognormal noise."""
        rng = rng or np.random.RandomState(self._seed)
        total, t_mem, t_cmp = self._times(table)
        n = len(table)
        noise = np.exp(rng.normal(0.0, self.noise, size=(3, repeats, n)))
        return ProbeBatch(
            total_time_s=total[None, :] * noise[0],
            mem_time_s=t_mem[None, :] * noise[1],
            compute_time_s=t_cmp[None, :] * noise[2],
            grid_steps=np.asarray(table.grid_steps),
            stage_bytes=np.asarray(table.stage_bytes),
            blocks_resident=np.asarray(table.blocks_resident),
        )

    def true_time_batch(self, table: TrafficTable) -> np.ndarray:
        """Noise-free times (evaluation only, never read by the fitter)."""
        return self._times(table)[0]


def kernel_sources_digest() -> str:
    """SHA-256 over every CUDA source of the port's kernel library, each as
    ``kernels._build.source_bytes`` gives it (the source and every header
    it may include)."""
    from ..kernels import _build

    h = hashlib.sha256()
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        h.update(name.encode() + b"\0" + _build.source_bytes(name))
    return h.hexdigest()


class CudaEventTimer(DeviceModel):
    """The real oracle: the port's kernel, timed on the card.

    For each row of a traffic table it launches the kernel at the row's
    (D, P) ``warmup`` times untimed, then once per repeat between two
    ``torch.cuda.Event``s on the current stream.  Before each timed launch
    the card reads a buffer of twice its L2 size, which leaves the L2 cache
    holding clean lines of that buffer and nothing of the kernel's: every
    timed launch reads its inputs from device memory, as a launch at a size
    whose inputs exceed the L2 does, and finds no dirty line of the previous
    launch's output to write back.  Without it a probe at a small size (the
    layernorm's 4-16 MB at r 512-2048) re-read its inputs from the L2 that
    the previous launch filled, and the fit mistook that for the kernel's
    speed at the sizes it chooses for.  Then the card spins for
    ``SPIN_CYCLES`` clock cycles (``torch.cuda._sleep``), so it is still
    busy while the host records the start event and runs the wrapper;
    otherwise a kernel shorter than the wrapper's host time would be timed
    with the host's gap in it.  ``probe_batch`` returns
    those per-launch times split by the roofline rule in this module's
    docstring; ``true_time_batch`` returns the median of ``timings``
    launches per row.  Inputs are made once per data size from ``seed``.
    ``kernels.ops.probe_launcher`` binds the inputs and launches.  There
    is no CPU fallback: without a card the constructor raises.

    The spin covers the host only if the host enqueues the start event,
    the launch and the end event before it ends.  A host that another
    thread or process preempts can take longer, and the launch is then
    timed with the host's gap in it.  So the host times that window, and a
    launch whose window reached ``SPIN_CYCLES`` at the boost clock is
    timed again behind a spin four times as long, up to ``RETIMES``
    times; ``late`` counts such windows.

    Each row -- its input binding, warm-ups, flushes, spins, events and
    launches -- runs while it holds the card's ``CardLock``
    (core/card_lock.py), so timed probes of two threads or two processes
    on one card take turns row by row; ``beat`` (optional) is called
    while waiting for the lock and between rows -- a tuning-farm worker's
    lease heartbeat.  ``warm`` loads every kernel library and makes the
    CUDA context, under the lock, before the first probe.
    """

    SPIN_CYCLES = 200_000     # about 100 us at the H100's boost clock
    BOOST_HZ = 1.98e9         # the H100 SXM's highest SM clock
    RETIMES = 3
    beat: Callable[[], object] | None = None

    def __init__(self, hw: HardwareParams | None = None,
                 device: str | torch.device = "cuda", warmup: int = 1,
                 timings: int = 3, seed: int = 0,
                 beat: Callable[[], object] | None = None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(
                f"CudaEventTimer times a CUDA device, not {self.device}")
        if not torch.cuda.is_available():
            raise RuntimeError("CudaEventTimer needs a CUDA device")
        self.hw = hw or HardwareParams.from_device(self.device)
        self.warmup = int(warmup)
        self.timings = int(timings)
        self.seed = int(seed)
        self.beat = beat
        self._bound: tuple | None = None
        self._flush: torch.Tensor | None = None
        self._lock = CardLock.for_device(self.device)
        self.late = 0

    def warm(self) -> None:
        """Load (building if needed) every kernel library and make the CUDA
        context, so no later probe -- and no farm lease -- waits on them."""
        from ..kernels import _build

        with self._lock.hold(self.beat):
            for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
                _build.load(name)
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize(self.device)

    def fingerprint(self) -> dict:
        """The timer's settings and the hash of the kernel library's
        sources: a driver tuned on other kernel code is another build."""
        return {"class": type(self).__name__, "hw": self.hw.name,
                "warmup": self.warmup, "timings": self.timings,
                "seed": self.seed, "sources": kernel_sources_digest()}

    def _launch_fn(self, kernel: str, D: Mapping[str, int]):
        key = (kernel, tuple(sorted(D.items())))
        if self._bound is None or self._bound[0] != key:
            from ..kernels.ops import probe_launcher
            self._bound = None   # release the previous size's buffers first
            self._bound = (key, probe_launcher(kernel, D, self.device,
                                               self.seed))
        return self._bound[1]

    def _flush_l2(self) -> None:
        """Read twice the L2's bytes on the current stream (see the class
        docstring)."""
        if self._flush is None:
            self._flush = torch.zeros(2 * self.hw.l2_bytes // 4,
                                      device=self.device)
        self._flush.sum()

    def _time_launch(self, launch, P, start, end, stream) -> None:
        """Record one timed launch of ``launch(P)`` between ``start`` and
        ``end``; again, behind a longer spin, while the host's enqueue
        outlasted the spin before it (see the class docstring)."""
        spin = self.SPIN_CYCLES
        for _ in range(self.RETIMES + 1):
            self._flush_l2()
            t0 = time.perf_counter()
            torch.cuda._sleep(spin)
            start.record(stream)
            launch(P)
            end.record(stream)
            if time.perf_counter() - t0 < spin / self.BOOST_HZ:
                return
            self.late += 1
            spin *= 4

    def _time_rows(self, table: TrafficTable, n_timed: int) -> np.ndarray:
        """(n_timed, n) seconds: one timed launch per entry, each row under
        the card's lock."""
        out = np.empty((n_timed, len(table)))
        stream = torch.cuda.current_stream(self.device)
        for i in range(len(table)):
            if self.beat is not None:
                self.beat()
            P = {p: int(c[i]) for p, c in table.config.items()}
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(n_timed)]
            with self._lock.hold(self.beat), torch.cuda.device(self.device):
                launch = self._launch_fn(table.kernel, table.D)
                for _ in range(self.warmup):
                    launch(P)
                for start, end in events:
                    self._time_launch(launch, P, start, end, stream)
                events[-1][1].synchronize()
            out[:, i] = [s.elapsed_time(e) * 1e-3 for s, e in events]
        return out

    def probe_batch(self, table: TrafficTable,
                    rng: np.random.RandomState | None = None,
                    repeats: int = 1) -> ProbeBatch:
        total = self._time_rows(table, repeats)
        t_mem, t_cmp = roofline_times(table, self.hw)
        share = t_mem / np.maximum(t_mem + t_cmp, 1e-300)
        mem = total * share[None, :]
        return ProbeBatch(
            total_time_s=total,
            mem_time_s=mem,
            compute_time_s=total - mem,
            grid_steps=np.asarray(table.grid_steps),
            stage_bytes=np.asarray(table.stage_bytes),
            blocks_resident=np.asarray(table.blocks_resident),
        )

    def true_time_batch(self, table: TrafficTable) -> np.ndarray:
        return np.median(self._time_rows(table, self.timings), axis=0)
