"""Shared-memory load cost on the card: SM cycles per warp-wide load, by
width and by how many distinct addresses each 8-lane quarter of the warp
reads.  What the f32 SIMT mainloop (``kernels/csrc/gemm_simt.cuh``) is
laid out against::

    python -m repro_torch.benchmarks.smem_loads

One CTA of 1024 threads per SM issues independent ``ld.shared`` loads of 4,
8 or 16 bytes in a loop; the cycles of CTA 0 (``clock64``) over the warp
loads of its SM give the cost of one warp load.  An SM moves one 128-byte
wavefront per cycle, so a cost of c is c wavefronts.  Runs only on a CUDA
card (nvcc builds the probe into ``build/repro_torch/``).
"""

from __future__ import annotations

import subprocess

# (name, bytes per lane, lane -> vector index): the access patterns.
PATTERNS = (
    ("4 B, 32 distinct", 4, "lane"),
    ("8 B, 32 distinct", 8, "lane"),
    ("8 B, 1 per quarter", 8, "lane / 8"),
    ("8 B, 2 per quarter", 8, "lane % 2"),
    ("8 B, 4 per quarter", 8, "lane % 4"),
    ("8 B, 8 per quarter", 8, "lane % 8"),
    ("16 B, 32 distinct", 16, "lane"),
    ("16 B, 1 per quarter", 16, "lane / 8"),
    ("16 B, 2 per quarter", 16, "lane % 2"),
    ("16 B, 4 per quarter", 16, "lane % 4"),
    ("16 B, 8 per quarter", 16, "lane % 8"),
)

_KERNEL = r"""
#include <cstdio>
template <int W, int P>
__global__ void probe(float* out, long long* cycles, int iters) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int idx = @SELECT@;
  const unsigned base = (unsigned)__cvta_generic_to_shared(s) + idx * W;
  float acc = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const unsigned a = base + (((it * 16 + u) & 31) * 512);
      if (W == 16) {
        float x, y, z, w;
        asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(a));
        acc += x + y + z + w;
      } else if (W == 8) {
        float x, y;
        asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];" : "=f"(x), "=f"(y) : "r"(a));
        acc += x + y;
      } else {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
        acc += x;
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
template <int W, int P>
double run() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 132 * 1024 * 4);
  cudaMalloc(&cyc, 132 * 8);
  const int iters = 2000, threads = 1024;
  probe<W, P><<<132, threads>>>(out, cyc, iters);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.0;
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return (double)c / ((double)iters * 16 * (threads / 32));
}
int main() {
@CALLS@
  return 0;
}
"""


def source() -> str:
    """The probe's CUDA source, one instantiation per pattern."""
    select = " ".join(f"P == {i} ? ({expr}) :"
                      for i, (_, _, expr) in enumerate(PATTERNS)) + " 0"
    calls = "\n".join(f'  printf("%.3f\\n", run<{w}, {i}>());'
                      for i, (_, w, _) in enumerate(PATTERNS))
    return _KERNEL.replace("@SELECT@", select).replace("@CALLS@", calls)


def main() -> list[str]:
    from ..kernels._build import BUILD_DIR, _nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, exe = BUILD_DIR / "smem_loads.cu", BUILD_DIR / "smem_loads"
    cu.write_text(source())
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(cu)], check=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    costs = subprocess.run([str(exe)], capture_output=True, text=True,
                           check=True).stdout.split()
    lines = [f"smem_loads on {card}: SM cycles per warp load"]
    lines += [f"  {name}: {float(c):.3f}"
              for (name, _, _), c in zip(PATTERNS, costs)]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    main()
