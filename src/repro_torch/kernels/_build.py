"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled, at
first use, into ``build/repro_torch/lib<name>-<hash>.so`` under the
repository root (a git-ignored directory).  The hash covers the source,
every header in ``csrc/`` (``*.cuh``, which a source may include) and the
flags, so an edited source or header builds anew and a stale library is
never loaded.  ``nvcc -Xptxas -v`` output (registers, shared memory and
spills per kernel) is kept beside the library as ``.log``.  There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_all",
           "build_log", "load", "source_bytes"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def source_bytes(name: str, csrc: Path | None = None) -> bytes:
    """``csrc/<name>.cu`` followed by every ``csrc/*.cuh``, sorted by name:
    what a build of ``name`` compiles."""
    csrc = csrc or CSRC
    parts = [(csrc / f"{name}.cu").read_bytes()]
    parts += [h.name.encode() + h.read_bytes()
              for h in sorted(csrc.glob("*.cuh"))]
    return b"\0".join(parts)


def _library_path(name: str, csrc: Path | None = None) -> Path:
    digest = hashlib.sha256(source_bytes(name, csrc)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all() -> list[Path]:
    """Build every source in ``csrc/``, one nvcc each, all at once."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def build_log(name: str) -> str:
    """nvcc's report for the current build of ``name`` ('' if not built)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build(name)))
