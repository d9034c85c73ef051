"""CUDA graphs of serving steps: capture once, replay on every call.

The JAX engine compiles its decode step once with ``jax.jit`` and replays
the executable; a PyTorch step runs eagerly, one host launch per op, and on
a decode step of a few hundred small kernels the host is the bottleneck.
``StepGraph`` is the counterpart of the jitted step: a step function over
static buffers, captured into one ``torch.cuda.CUDAGraph`` and replayed.

The contract of a captured step:

- **Static buffers.**  ``fn`` reads its inputs from tensors it closes over
  and that the caller refills in place before each call; its outputs are
  the tensors of the capture, overwritten by each replay (read them before
  the next call).  A graph keeps every address it was captured with --
  operands, workspaces, the TMA descriptors the wgmma kernels encode on the
  host -- so nothing it reads may be reallocated.
- **The first call is eager.**  It runs ``fn`` for real (the step's state,
  a KV cache or a Mamba state, advances once), which also builds and loads
  every kernel library, sizes every workspace and warms the libraries, so
  nothing of that happens inside the capture.  Then it captures ``fn``;
  capturing executes nothing.  Every later call replays.  A capture that
  fails raises: there is no eager fallback on the card.
- **One stream.**  The eager call, the capture and the replays all run on
  one side ``stream`` (the kernels keep their zeroed workspaces per
  stream, so the capture finds the eager call's, and a capture cannot run
  on the default stream), ordered after the caller's stream and before
  its next work; the captures of one owner share one memory ``pool``.
- **Launch counts.**  A replay does not call the kernel wrappers, so their
  ``LAUNCHES`` counters would stop at the capture.  The capture records
  how many launches of each kernel one replay makes (``launches``) and
  rolls the counters back (a capture launches nothing); ``replays`` counts
  the replays, so the launches a graph made are ``replays * launches``.

On the CPU there is nothing to capture: every call runs ``fn`` eagerly.

``BranchGraphs`` holds one ``StepGraph`` per branch of a
``core.device_plan.BucketedDispatch``, over envelope-padded buffers: the
port's form of the JAX package's one trace for every raw shape.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Mapping

import torch

from ..kernels import flash_attention, layernorm, matmul, moe_gmm, reduce
from ..kernels import ssd_scan

__all__ = ["BranchGraphs", "LAUNCH_COUNTERS", "StepGraph", "graph_launches",
           "launch_counts", "on_stream"]

# The launch counter of every kernel, by the name the kernel rows use.
LAUNCH_COUNTERS = {
    "matmul": matmul.LAUNCHES,
    "flash_attention": flash_attention.LAUNCHES,
    "ssd_scan": ssd_scan.LAUNCHES,
    "moe_gmm": moe_gmm.LAUNCHES,
    "layernorm": layernorm.LAUNCHES,
    "colsum": reduce.LAUNCHES,
}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch counter, by name."""
    return {name: c.count for name, c in LAUNCH_COUNTERS.items()}


@contextlib.contextmanager
def on_stream(device: torch.device, stream: torch.cuda.Stream | None):
    """Run the enclosed calls on ``device`` and ``stream`` (nothing to do
    on the CPU)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class StepGraph:
    """``fn()`` over static buffers: a CUDA graph on the card (the first
    call eager, then captured, then replayed), eager on the CPU.

    ``on_build`` is called once when the step is built: on the CPU when the
    object is made, on the card when the capture ends (what an engine's
    ``compile_counts`` count).  ``capture_s`` is the capture's wall
    seconds, ``record_s`` the part of them spent recording ``fn`` (the rest
    ends the capture and instantiates the graph), and ``pool_bytes`` the
    device memory the capture added to what
    the caching allocator reserves (the pool's growth: its first capture
    sizes it, later ones reuse what it holds).
    """

    def __init__(self, fn: Callable[[], object], device: torch.device,
                 stream: torch.cuda.Stream | None = None, pool=None,
                 on_build: Callable[[], None] | None = None) -> None:
        self.fn = fn
        self.device = torch.device(device)
        if self.graphed and stream is None:
            stream = torch.cuda.Stream(self.device)
        self.stream = stream
        self.pool = pool
        self.on_build = on_build
        self.graph: torch.cuda.CUDAGraph | None = None
        self.output = None
        self.launches: dict[str, int] = {}
        self.replays = 0
        self.capture_s: float | None = None
        self.record_s: float | None = None
        self.pool_bytes: int | None = None
        if not self.graphed and on_build is not None:
            on_build()

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def __call__(self):
        if not self.graphed:
            return self.fn()
        caller = torch.cuda.current_stream(self.device)
        if self.stream != caller:
            self.stream.wait_stream(caller)
        with on_stream(self.device, self.stream):
            if self.graph is None:
                out = self.fn()          # the real step, eagerly
                self._capture()
            else:
                self.graph.replay()
                self.replays += 1
                out = self.output
        if self.stream != caller:
            caller.wait_stream(self.stream)
            if isinstance(out, torch.Tensor) and out is not self.output:
                out.record_stream(caller)
        return out

    def _capture(self) -> None:
        before = launch_counts()
        torch.cuda.empty_cache()     # as the capture does, before measuring
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = self.fn()
            t1 = time.perf_counter()
        self.capture_s = time.perf_counter() - t0
        self.record_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        for name, counter in LAUNCH_COUNTERS.items():
            counter.count = before[name]     # a capture launches nothing
        self.graph, self.output = graph, out
        if self.on_build is not None:
            self.on_build()

    def launched(self) -> dict[str, int]:
        """The kernel launches this graph's replays made, by kernel."""
        return {k: n * self.replays for k, n in self.launches.items()}


def graph_launches(steps) -> dict[str, int]:
    """The kernel launches the replays of ``steps`` made, summed by
    kernel."""
    out: dict[str, int] = {}
    for step in steps:
        for k, n in step.launched().items():
            out[k] = out.get(k, 0) + n
    return out


class BranchGraphs:
    """One ``StepGraph`` per branch of a ``BucketedDispatch``.

    ``fn(dims)`` launches the op over the envelope-padded buffers the
    caller owns (``ops.matmul(xp, yp, in_graph=disp, dims=dims)``), where
    the op takes the branch ``disp.host_index(dims)`` names.  A call with a
    raw shape of a branch already captured replays that branch's graph; a
    new branch is run eagerly once and captured.  So the captures are at
    most ``disp.n_branches`` whatever the number of raw shapes, and
    ``captures`` counts them (on the CPU: the step objects made).
    """

    def __init__(self, disp, fn: Callable[[Mapping[str, int]], object],
                 device: torch.device | str,
                 stream: torch.cuda.Stream | None = None) -> None:
        self.disp = disp
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and stream is None:
            stream = torch.cuda.Stream(self.device)
        self.stream = stream      # one stream, one pool for every branch
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.steps: dict[int, StepGraph] = {}
        self.captures = 0

    def _built(self) -> None:
        self.captures += 1

    def __call__(self, dims: Mapping[str, int]):
        """The op's envelope-shaped output at raw ``dims`` (the graph's
        static output on the card: read it before the next call)."""
        idx, _ = self.disp.host_index(dims)
        step = self.steps.get(idx)
        if step is None:
            # the branch's launch depends on ``dims`` only through the
            # branch, so the capture serves every raw shape of it
            step = StepGraph(lambda d=dict(dims): self.fn(d), self.device,
                             self.stream, self.pool, on_build=self._built)
            self.steps[idx] = step
        return step()

    def launched(self) -> dict[str, int]:
        return graph_launches(self.steps.values())
