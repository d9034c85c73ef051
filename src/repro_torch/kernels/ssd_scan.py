"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel's wrapper and its
plain version.

``ssd_scan_kernel`` launches ``csrc/ssd_scan.cu`` (the Hopper port of the JAX
package's ``ssd_scan_pallas``) with launch parameter ``chunk``.  x is (bh, s,
dh), dt (bh, s), A (bh,), and B and C (bh / h, s, n), each shared by h
consecutive rows of x: h is inferred from the shapes, and h = 1 is the
reference's per-head interface.  x, B and C are bf16 or f32 of one type, dt
and A are f32 (the layer computes them in f32), and y has x's type.

The kernel is bound by bytes and by the chain of chunk states, so it runs
every chunk of every row as a CTA of its own, all in parallel: a CTA
computes what needs no other chunk, then takes the previous chunk's f32
state from an L2 ring (two slots per chain, which the wrapper allocates),
publishes its own and finishes its rows.  The h rows that share B and C run
each chunk together, so B and C come from device memory once per group.
bf16 at a compiled (dh, n) (``SSD_SM90_SHAPES``) runs the wgmma body with
the compiled chunks only (``SSD_SM90_CHUNKS``; another chunk raises, on the
CPU too); f32, and bf16 at other shapes, the SIMT body, whose chunk is any
multiple of 32 whose stage fits in shared memory.  The kernel masks a ragged
last chunk, so the chunk need not divide s.

``ssd_scan_plain`` computes the same chunked function in plain PyTorch, f32
inside: per chunk the decay-gated quadratic form and the carried state's
term, then the state update, with a shorter last chunk where the chunk does
not divide s.  The tests use it, and the wrapper takes it only for tensors on
the CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES.count``
counts kernel launches and nothing else.

With ``return_states=True`` both also return each chunk's entering state,
f32 (bh, chunks, n, dh), which the backward reads:
``ssd_scan_backward_kernel`` launches ``csrc/ssd_scan_bwd.cu`` (no TPU
counterpart: the JAX package differentiates ``ssd_parallel`` with XLA) and
gives (dx, ddt, dB, dC, dA) from them and dy at the same chunk; its plain
version is ``ssd_scan_backward_plain``.  Like the forward it has two
bodies: bf16 at a compiled (dh, n, chunk) runs the wgmma body (one CTA per
(row, chunk), every product on the tensor cores), f32 and bf16 at other
shapes the SIMT body (one CTA per (row, 16 head-dim columns, chunk)).
``BACKWARD_LAUNCHES`` counts its calls (a call launches the backward and
its reduction) and keeps the chunk and the body ("sm90" or "simt") of the
last call at each (bh, s, dh, n).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.kernel_spec import (SSD_COLS, SSD_GPAD, SSD_ROWS,
                                SSD_SM90_CHUNKS,
                                SSD_STATE_SLOTS, SSD_THREADS, ssd_smem_bytes,
                                ssd_uses_sm90)
from ._build import load
from ._workspace import zeroed_ints
from .matmul import LaunchCounter

__all__ = ["BACKWARD_LAUNCHES", "DTYPES", "LAUNCHES", "backward_attributes",
           "backward_body", "backward_smem_bytes",
           "backward_tile_attributes", "backward_tile_smem",
           "kernel_attributes", "ssd_ctas", "ssd_scan_backward_kernel",
           "ssd_scan_backward_plain", "ssd_scan_kernel", "ssd_scan_plain",
           "tile_attributes"]

DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to
_NEG_INF = -1e30
# the backward's wgmma body: per-row f32 vectors of the chunk in shared
# memory, and the bytes beyond its tiles and vectors (the 1 KiB alignment
# slack, the per-warp sums, the mbarrier and the ticket)
_BWD_SM90_VECTORS = 9
_BWD_SM90_SMEM_EXTRA = 1024 + 128

LAUNCHES = LaunchCounter()
BACKWARD_LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_ssd_scan.argtypes = [vp] * 9 + [i] * 7 + [vp]
    lib.klaraptor_ssd_scan.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_ssd_scan_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_ssd_scan_attributes.restype = i
    lib.klaraptor_ssd_scan_tile_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.klaraptor_ssd_scan_tile_attributes.restype = i
    lib.klaraptor_ssd_error_string.argtypes = [i]
    lib.klaraptor_ssd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = load("ssd_scan_bwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.klaraptor_ssd_scan_bwd.argtypes = [vp] * 18 + [i] * 8 + [vp]
    lib.klaraptor_ssd_scan_bwd.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.klaraptor_ssd_scan_bwd_attributes.argtypes = [i, ip, ip, ip]
    lib.klaraptor_ssd_scan_bwd_attributes.restype = i
    lib.klaraptor_ssd_scan_bwd_tile_attributes.argtypes = [i, i, i, ip, ip,
                                                           ip]
    lib.klaraptor_ssd_scan_bwd_tile_attributes.restype = i
    lib.klaraptor_ssd_scan_bwd_tile_smem.argtypes = [i, i, i]
    lib.klaraptor_ssd_scan_bwd_tile_smem.restype = i
    lib.klaraptor_ssd_error_string.argtypes = [i]
    lib.klaraptor_ssd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, rc: int, lib: ctypes.CDLL | None = None) -> None:
    msg = (lib or _lib()).klaraptor_ssd_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _read_attributes(fn, *args, lib=None) -> dict[str, int]:
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*args, *[ctypes.byref(v) for v in vals])
    if rc:
        _raise_cuda("cudaFuncGetAttributes", rc, lib)
    return dict(zip(("num_regs", "max_threads", "local_bytes"),
                    (v.value for v in vals)))


def kernel_attributes(dtype: torch.dtype) -> dict[str, int]:
    """Registers per thread, thread limit and spilled local bytes of the
    SIMT body compiled for ``dtype`` (builds it if needed)."""
    return _read_attributes(_lib().klaraptor_ssd_scan_attributes,
                            _DTYPE_CODE[dtype])


def tile_attributes(dh: int, n: int, chunk: int) -> dict[str, int]:
    """The same for the bf16 wgmma instantiation (dh, n, chunk)."""
    return _read_attributes(_lib().klaraptor_ssd_scan_tile_attributes, dh, n,
                            chunk)


def backward_attributes(dtype: torch.dtype) -> dict[str, int]:
    """The same for the backward's SIMT kernel compiled for ``dtype``."""
    lib = _bwd_lib()
    return _read_attributes(lib.klaraptor_ssd_scan_bwd_attributes,
                            _DTYPE_CODE[dtype], lib=lib)


def backward_tile_attributes(dh: int, n: int, chunk: int) -> dict[str, int]:
    """The same for the backward's bf16 wgmma instantiation (dh, n,
    chunk)."""
    lib = _bwd_lib()
    return _read_attributes(lib.klaraptor_ssd_scan_bwd_tile_attributes, dh,
                            n, chunk, lib=lib)


def backward_tile_smem(dh: int, n: int, chunk: int) -> int:
    """The dynamic shared memory the compiled wgmma instantiation (dh, n,
    chunk) launches with (-1 if there is none): what
    ``backward_smem_bytes`` counts, as the kernel counts it."""
    return _bwd_lib().klaraptor_ssd_scan_bwd_tile_smem(dh, n, chunk)


def backward_body(dh: int, n: int, chunk: int, dtype: torch.dtype) -> str:
    """The body the backward runs: "sm90" (bf16 at a compiled (dh, n,
    chunk)) or "simt"."""
    return "sm90" if ssd_uses_sm90(dh, n, torch.finfo(dtype).bits // 8) \
        and chunk in SSD_SM90_CHUNKS else "simt"


def backward_smem_bytes(chunk: int, n: int, elem_bytes: int,
                        dh: int = SSD_COLS) -> int:
    """Dynamic shared memory of one backward CTA.  wgmma body: x and dy
    (chunk x dh) and B and C (chunk x n) in bf16, the hi and lo bf16 tiles
    of h_in and of dh_out (n x dh each), nine per-row f32 vectors (chunk)
    and the extra bytes.  SIMT body: B^T and C^T (n x chunk) and the x and
    dy columns (chunk x SSD_COLS) in the input type; h_in and dh (n x
    SSD_COLS), dx's state term (chunk x SSD_COLS), three padded score tiles
    (SSD_ROWS x chunk) and eight per-row vectors (chunk), f32."""
    if ssd_uses_sm90(dh, n, elem_bytes) and chunk in SSD_SM90_CHUNKS:
        return ((2 * chunk * dh + 2 * chunk * n + 4 * n * dh) * 2
                + 4 * _BWD_SM90_VECTORS * chunk + _BWD_SM90_SMEM_EXTRA)
    return ((2 * n + 2 * SSD_COLS) * chunk * elem_bytes
            + 4 * (2 * n * SSD_COLS + SSD_COLS * chunk
                   + 3 * SSD_ROWS * (chunk + SSD_GPAD) + 8 * chunk))


def ssd_ctas(bh: int, s: int, dh: int, n: int, chunk: int,
             dtype: torch.dtype) -> int:
    """CTAs of one launch: one per chunk of each row, times dh / SSD_COLS
    column blocks in the SIMT body."""
    chunks = -(-s // chunk)
    if ssd_uses_sm90(dh, n, torch.finfo(dtype).bits // 8):
        return bh * chunks
    return bh * (dh // SSD_COLS) * chunks


def _per_row(t: torch.Tensor, bh: int) -> torch.Tensor:
    """B or C (bh / h, s, n) as one copy per row of x (bh, s, n)."""
    g = t.shape[0]
    return t[:, None].expand(g, bh // g, *t.shape[1:]).reshape(bh,
                                                                *t.shape[1:])


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, chunk: int = 256, *,
                   return_states: bool = False):
    """The SSD scan in plain PyTorch, chunk by chunk, f32 inside; the output
    has x's dtype.  x (bh, s, dh); dt (bh, s); B, C (bh / h, s, n), each
    shared by h consecutive rows of x; A (bh,).  With ``return_states``
    also each chunk's entering state, f32 (bh, chunks, n, dh) (zeros for
    the first chunk): what the backward reads."""
    bh, s, dh = x.shape
    n = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = _per_row(B.float(), bh), _per_row(C.float(), bh)
    a = A.float()[:, None]                                  # (bh, 1)
    state = torch.zeros(bh, n, dh, dtype=torch.float32, device=x.device)
    out = torch.empty(bh, s, dh, dtype=torch.float32, device=x.device)
    entering = []
    for c0 in range(0, s, chunk):                # the last chunk may be short
        c1 = min(c0 + chunk, s)
        entering.append(state)
        xc, dc, Bc, Cc = xf[:, c0:c1], dtf[:, c0:c1], Bf[:, c0:c1], Cf[:, c0:c1]
        cum = torch.cumsum(a * dc, dim=1)                   # (bh, L) inclusive
        total = cum[:, -1:]                                 # (bh, 1)
        gate = _decay(cum) * dc[:, None, :]                 # (bh, L, L)
        scores = torch.einsum("bin,bjn->bij", Cc, Bc) * gate
        out[:, c0:c1] = scores @ xc + (Cc * torch.exp(cum)[..., None]) @ state
        w = torch.exp(total - cum) * dc                     # (bh, L)
        state = torch.exp(total)[..., None] * state + torch.einsum(
            "bjn,bjd->bnd", Bc * w[..., None], xc)
    if not return_states:
        return out.to(x.dtype)
    states = torch.stack(entering, dim=1) if entering else \
        torch.zeros(bh, 0, n, dh, dtype=torch.float32, device=x.device)
    return out.to(x.dtype), states


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) for j <= i, else 0, of a chunk's running sums
    (bh, L) -> (bh, L, L).  The exponent is masked before exp: for i < j it
    is positive and would overflow, and 0 x inf is a NaN gradient."""
    idx = torch.arange(cum.shape[1], device=cum.device)
    causal = idx[:, None] >= idx[None, :]
    expnt = (cum[:, :, None] - cum[:, None, :]).masked_fill(~causal,
                                                            _NEG_INF)
    return torch.exp(expnt)


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            B: torch.Tensor, C: torch.Tensor,
                            A: torch.Tensor, states: torch.Tensor,
                            dy: torch.Tensor, chunk: int):
    """(dx, ddt, dB, dC, dA) of the SSD scan in plain PyTorch, f32 inside,
    chunk by chunk in reverse, from the forward's entering ``states`` (bh,
    chunks, n, dh) and the output's gradient dy (bh, s, dh).  dx has x's
    dtype, dB and dC B's (summed over the h rows that share them), ddt
    (bh, s) and dA (bh,) are f32.

    Within a chunk (cum the running sum of A dt, total its last entry, E_ij
    = exp(cum_i - cum_j) for j <= i, w_j = exp(total - cum_j) dt_j) the
    state gradient carried in from the later chunks, dh_out, gives
    dh_in = exp(total) dh_out + sum_i exp(cum_i) C_i^T dy_i for the chunk
    before, and with M_ij = dy_i . x_j, G_ij = (C_i . B_j) E_ij:
      dx_j = dt_j sum_i G_ij dy_i + w_j dh_out^T B_j
      dB_j = sum_i M_ij E_ij dt_j C_i + w_j dh_out x_j
      dC_i = sum_j M_ij E_ij dt_j B_j + exp(cum_i) h_in dy_i
    and the decay exponents' gradient dcum_i = sum_j P_ij - sum_j P_ji +
    exp(cum_i) dy_i . (C_i h_in) - w_i R_i (P_ij = G_ij M_ij dt_j, R_j =
    x_j . dh_out^T B_j), plus dtotal = sum_j w_j R_j + exp(total) <h_in,
    dh_out> on the last entry; ddt and dA take its reverse running sum
    times A and dt, and ddt_j the direct terms sum_i G_ij M_ij + exp(total
    - cum_j) R_j."""
    bh, s, dh = x.shape
    g, n = B.shape[0], B.shape[-1]
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    Bf, Cf = _per_row(B.float(), bh), _per_row(C.float(), bh)
    a = A.float()[:, None]
    dx = torch.empty(bh, s, dh, dtype=torch.float32, device=x.device)
    ddt = torch.empty(bh, s, dtype=torch.float32, device=x.device)
    dB = torch.empty(bh, s, n, dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros(bh, dtype=torch.float32, device=x.device)
    dh_out = torch.zeros(bh, n, dh, dtype=torch.float32, device=x.device)
    starts = list(range(0, s, chunk))
    for c in reversed(range(len(starts))):
        c0 = starts[c]
        c1 = min(c0 + chunk, s)
        xc, dc, Bc, Cc, dyc = (xf[:, c0:c1], dtf[:, c0:c1], Bf[:, c0:c1],
                               Cf[:, c0:c1], dyf[:, c0:c1])
        h_in = states[:, c].float()
        cum = torch.cumsum(a * dc, dim=1)
        total = cum[:, -1:]
        E = _decay(cum)
        G = torch.einsum("bin,bjn->bij", Cc, Bc) * E
        M = torch.einsum("bid,bjd->bij", dyc, xc)
        W = M * E * dc[:, None, :]
        P = G * M * dc[:, None, :]
        ec = torch.exp(cum)
        w = torch.exp(total - cum) * dc
        Bdh = torch.einsum("bjn,bnd->bjd", Bc, dh_out)
        R = (Bdh * xc).sum(-1)
        Q = ec * (torch.einsum("bin,bnd->bid", Cc, h_in) * dyc).sum(-1)
        dx[:, c0:c1] = dc[..., None] * torch.einsum("bij,bid->bjd", G, dyc) \
            + w[..., None] * Bdh
        dB[:, c0:c1] = torch.einsum("bij,bin->bjn", W, Cc) \
            + w[..., None] * torch.einsum("bnd,bjd->bjn", dh_out, xc)
        dC[:, c0:c1] = torch.einsum("bij,bjn->bin", W, Bc) \
            + ec[..., None] * torch.einsum("bnd,bid->bin", h_in, dyc)
        dcum = P.sum(2) - P.sum(1) + Q - w * R
        dtotal = (w * R).sum(-1, keepdim=True) \
            + torch.exp(total) * (h_in * dh_out).sum((1, 2))[:, None]
        rev = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,)) \
            + dtotal
        ddt[:, c0:c1] = (G * M).sum(1) + torch.exp(total - cum) * R + a * rev
        dA += (dc * rev).sum(-1)
        dh_out = torch.exp(total)[..., None] * dh_out + torch.einsum(
            "bin,bid->bnd", Cc * ec[..., None], dyc)
    dB = dB.view(g, bh // g, s, n).sum(1)
    dC = dC.view(g, bh // g, s, n).sum(1)
    return dx.to(x.dtype), ddt, dB.to(B.dtype), dC.to(C.dtype), dA


def _check(x, dt, B, C, A, chunk) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.ndim != 3 or B.ndim != 3 or B.shape != C.shape \
            or B.shape[1] != x.shape[1] or B.shape[0] < 1 \
            or x.shape[0] % B.shape[0] \
            or tuple(dt.shape) != x.shape[:2] \
            or tuple(A.shape) != x.shape[:1]:
        raise ValueError(f"the SSD scan takes x (bh, s, dh), dt (bh, s), B "
                         f"and C (bh / h, s, n), each shared by h "
                         f"consecutive rows of x, and A (bh,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}, "
                         f"{tuple(A.shape)}")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in DTYPES \
            or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"the SSD scan takes x, B, C of one dtype in "
                         f"{DTYPES} and f32 dt and A; got {x.dtype}, "
                         f"{B.dtype}, {C.dtype}, {dt.dtype}, {A.dtype}")
    tensors = (x, dt, B, C, A)
    if len({t.device for t in tensors}) != 1 \
            or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x, dt, B, C, A must share one cpu or cuda device; "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the SSD scan takes contiguous x, dt, B, C, A")
    bh, s, dh = x.shape
    n = B.shape[-1]
    if dh % SSD_COLS or n % 8:
        raise ValueError(f"head dim {dh} and state {n} are not ones the "
                         f"kernel takes (head dim divisible by {SSD_COLS}, "
                         f"state divisible by 8)")
    if not isinstance(chunk, int) or chunk <= 0:
        raise ValueError(f"chunk={chunk!r} must be a positive int")
    if ssd_uses_sm90(dh, n, x.element_size()):
        if chunk not in SSD_SM90_CHUNKS:
            raise ValueError(f"chunk={chunk} is not compiled for the bf16 "
                             f"wgmma body at (dh {dh}, n {n}): it has "
                             f"chunks {SSD_SM90_CHUNKS}")
    elif chunk % SSD_ROWS:
        raise ValueError(f"chunk={chunk!r} must be a positive multiple of "
                         f"{SSD_ROWS}")
    smem = ssd_smem_bytes(chunk, n, x.element_size(), dh)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs {smem} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a block can "
                         f"have")
    if x.numel() >= 2**31 or B.numel() >= 2**31 \
            or ssd_ctas(bh, s, dh, n, chunk, x.dtype) >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if x.device.type == "cuda" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("x, dt, B, C, A must be 16-byte aligned")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, *, chunk: int,
                    return_states: bool = False):
    """The SSD scan at chunk length ``chunk``: the CUDA kernel for CUDA
    tensors, ``ssd_scan_plain`` for CPU tensors (after the same checks).
    B and C may be (bh / h, s, n), shared by h consecutive rows of x.  With
    ``return_states`` also each chunk's entering state, f32 (bh, chunks, n,
    dh): the kernel writes the tile it reads from the chain (zeros for the
    first chunk), and y is the same bits either way."""
    _check(x, dt, B, C, A, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk,
                              return_states=return_states)
    bh, s, dh = x.shape
    n = B.shape[-1]
    out = torch.empty_like(x)
    entering = torch.empty((bh, -(-s // chunk), n, dh) if return_states
                           else (0,), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return (out, entering.zero_()) if return_states else out
    # a chain per row (per 16 head-dim columns in the SIMT body), a flag per
    # warp of a chain's CTA
    if ssd_uses_sm90(dh, n, x.element_size()):
        cols, warps = dh, 2 * chunk // 32
    else:
        cols, warps = SSD_COLS, SSD_THREADS // 32
    chains = bh * (dh // cols)
    states = torch.empty(chains * SSD_STATE_SLOTS * n * cols,
                         dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sync = zeroed_ints(x.device, stream, 1 + chains * warps)
        rc = _lib().klaraptor_ssd_scan(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), out.data_ptr(), states.data_ptr(), sync.data_ptr(),
            entering.data_ptr() if return_states else None,
            bh, s, dh, n, chunk, bh // B.shape[0], _DTYPE_CODE[x.dtype],
            stream)
    if rc:
        _raise_cuda("SSD scan kernel launch", rc)
    LAUNCHES.count += 1
    return (out, entering) if return_states else out


def ssd_scan_backward_kernel(x: torch.Tensor, dt: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor,
                             A: torch.Tensor, states: torch.Tensor,
                             dy: torch.Tensor, *, chunk: int,
                             body: str | None = None):
    """(dx, ddt, dB, dC, dA) of the SSD scan: ``csrc/ssd_scan_bwd.cu`` for
    CUDA tensors, ``ssd_scan_backward_plain`` for CPU tensors (after the
    same checks).  ``states`` are the forward's entering states at the same
    chunk (``ssd_scan_kernel(..., return_states=True)``), dy has x's shape
    and dtype.  bf16 at a compiled (dh, n, chunk) runs the wgmma body, one
    CTA per (row, chunk); everything else the SIMT body, one per (row,
    SSD_COLS head-dim columns, chunk) (``backward_body``).  Both run the
    chain of state gradients in reverse chunk order and write f32 partials
    that a second pass sums in a fixed order, so two calls give the same
    bits.  ``body="simt"`` runs the SIMT body where the wgmma body would
    run (to time one against the other); ``body="sm90"`` where it cannot
    run raises."""
    _check(x, dt, B, C, A, chunk)
    bh, s, dh = x.shape
    n = B.shape[-1]
    chunks = -(-s // chunk)
    if tuple(states.shape) != (bh, chunks, n, dh) \
            or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 {(bh, chunks, n, dh)}; got "
                         f"{tuple(states.shape)} {states.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be like x {tuple(x.shape)} {x.dtype}; "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    for name, t in (("states", states), ("dy", dy)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if chunk % SSD_ROWS:
        raise ValueError(f"the backward takes chunks that are multiples of "
                         f"{SSD_ROWS}, not {chunk}")
    auto = backward_body(dh, n, chunk, x.dtype)
    if body not in (None, "simt", auto):
        raise ValueError(f"body={body!r}: the backward runs 'simt' or "
                         f"{auto!r} at (dh {dh}, n {n}, chunk {chunk}, "
                         f"{x.dtype})")
    body = body or auto
    smem = backward_smem_bytes(chunk, n, x.element_size(),
                               dh if body == "sm90" else SSD_COLS)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the backward at chunk {chunk} needs {smem} bytes "
                         f"of shared memory, more than the {SMEM_LIMIT} a "
                         f"block can have")
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, dt, B, C, A, states, dy, chunk)
    if dy.data_ptr() % 16 or states.data_ptr() % 16:
        raise ValueError("dy and states must be 16-byte aligned")
    # a chain per row (per SSD_COLS head-dim columns in the SIMT body), a
    # flag per warp of a chain's CTA
    if body == "sm90":
        cols, warps = dh, 2 * chunk // 32
    else:
        cols, warps = SSD_COLS, SSD_THREADS // 32
    chains = bh * (dh // cols)
    dx = torch.empty_like(x)
    ddt = torch.empty(bh, s, dtype=torch.float32, device=x.device)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty(bh, dtype=torch.float32, device=x.device)
    if x.numel() == 0 or n == 0:
        return dx.zero_(), ddt.zero_(), dB.zero_(), dC.zero_(), dA.zero_()
    f32 = dict(dtype=torch.float32, device=x.device)
    # per chain partials of dB, dC, ddt and, per chunk, of dA
    part_bc = torch.empty(2, chains, s, n, **f32)
    part_dt = torch.empty(chains, s, **f32)
    part_a = torch.empty(chains, chunks, **f32)
    ring = torch.empty(chains * SSD_STATE_SLOTS * n * cols, **f32)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sync = zeroed_ints(x.device, stream, 1 + chains * warps,
                           "ssd_scan_bwd")
        rc = lib.klaraptor_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            part_bc[0].data_ptr(), part_bc[1].data_ptr(),
            part_dt.data_ptr(), part_a.data_ptr(), ring.data_ptr(),
            sync.data_ptr(), bh, s, dh, n, chunk, bh // B.shape[0],
            _DTYPE_CODE[x.dtype], int(body == "sm90"), stream)
    if rc:
        _raise_cuda("SSD scan backward launch", rc, lib)
    BACKWARD_LAUNCHES.launched((bh, s, dh, n), chunk=chunk, body=body)
    return dx, ddt, dB, dC, dA
