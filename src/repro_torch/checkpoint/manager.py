"""Checkpointing: atomic, async, keep-k, restore into a template.

The JAX package's ``checkpoint/manager.py`` over nested dicts of tensors,
with its on-disk layout exactly (one directory per step, written to a tmp
directory and then renamed, so readers never see a partial checkpoint):

    <root>/step_00000420/
        manifest.json       # step, aux, paths, dtypes, shapes
        arr_0000.npy ...    # one file per leaf, in sorted-key order

Leaf paths are spelt as ``jax.tree_util.keystr`` spells them
(``['params']['blocks']['pos0']['wq']``) and a bf16 leaf is saved as its
uint16 bit pattern with dtype ``"bfloat16"``, so a checkpoint either
package writes restores in the other.  ``save`` copies every leaf to host
memory on the calling thread (a consistent cut; the card's queue is drained
by the copy; a CPU leaf is copied too) and writes on a background thread.
``restore`` takes a template whose leaves have ``shape`` and ``dtype``
(tensors or specs) and puts each leaf on ``device`` (the card by default,
as the reference restores onto the default device), or, given the
reference's ``shardings=`` (a matching tree of
``distributed.sharding.TensorSharding``), makes each leaf a ``DTensor`` on
its mesh from this rank's block of the host array
(``distributed.elastic``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.device_model import resolve_device
from ..tree import tree_paths, tree_unflatten

__all__ = ["CheckpointManager"]

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int32: "int32",
              torch.int64: "int64", torch.int8: "int8", torch.uint8: "uint8",
              torch.bool: "bool"}


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array to save, the manifest's dtype string) of one leaf: a
    copy on every device (a CPU leaf's ``.to("cpu")`` would be the live
    tensor, which the next in-place train step overwrites while the write
    thread reads it)."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NP_DTYPES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return t.numpy(), _NP_DTYPES[t.dtype]


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@dataclass
class CheckpointManager:
    root: str
    keep: int = 3
    async_save: bool = True
    _thread: threading.Thread | None = field(default=None, repr=False)
    _error: list = field(default_factory=list, repr=False)
    # per save: step, host-copy seconds (calling thread), write seconds
    timings: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree: Any, aux: dict | None = None,
             block: bool = False) -> None:
        """Checkpoint ``tree`` at ``step``.  aux: small JSON state (data
        iterator position, etc.)."""
        self.wait()  # one in-flight save at a time; also surfaces errors
        t0 = time.perf_counter()
        leaves = tree_paths(tree)
        host = [_to_host(leaf) for _, leaf in leaves]
        timing = {"step": step, "copy_s": time.perf_counter() - t0}
        self.timings.append(timing)
        payload = (step, [p for p, _ in leaves], host, aux or {}, timing)
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=payload, daemon=True)
            self._thread.start()
        else:
            self._write(*payload)

    def _write(self, step, paths, host, aux, timing) -> None:
        t0 = time.perf_counter()
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "aux": aux, "paths": paths,
                        "dtypes": [], "shapes": []}
            for i, (arr, dtype) in enumerate(host):
                manifest["dtypes"].append(dtype)
                manifest["shapes"].append(list(arr.shape))
                np.save(os.path.join(tmp, f"arr_{i:04d}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()
        except Exception as e:  # surfaced on next save()/wait()
            self._error.append(e)
        timing["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise RuntimeError("async checkpoint failed") from self._error.pop()

    # -- restore --------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def restore(self, template: Any, step: int | None = None,
                shardings: Any = None,
                device: str | torch.device = "cuda"
                ) -> tuple[Any, dict, int]:
        """Load a checkpoint into ``template``'s tree structure, each leaf
        cast to the template leaf's dtype on ``device``, or with
        ``shardings`` a ``DTensor`` on its sharding's mesh (``device`` is
        then unused).  Returns (tree, aux, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {p: i for i, p in enumerate(manifest["paths"])}
        leaves = tree_paths(template)
        shards = ([s for _, s in tree_paths(shardings)]
                  if shardings is not None else [None] * len(leaves))
        if shardings is None:
            device = resolve_device(device)
        out = []
        for (p, tmpl), shard in zip(leaves, shards, strict=True):
            if p not in by_path:
                raise KeyError(f"checkpoint {d} missing leaf {p}")
            i = by_path[p]
            arr = np.load(os.path.join(d, f"arr_{i:04d}.npy"))
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"{p}: checkpoint shape {arr.shape} != "
                    f"{tuple(tmpl.shape)}")
            t = _from_host(arr, manifest["dtypes"][i])
            if shard is not None:
                out.append(shard.distribute(t.to(tmpl.dtype)))
            else:
                out.append(t.to(device=device, dtype=tmpl.dtype))
        return tree_unflatten(template, out), manifest["aux"], step

    # -- internals ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
