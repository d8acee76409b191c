"""What ``mma.sync`` gives on this card: the rate the K4 kernels could reach.

    python3 -m mvkpconv_tpu_torch.tools.mma_rate

Builds a small CUDA program with ``nvcc`` (sm_90a) in a temporary directory,
runs it and prints one JSON line per measurement, each in cycles per
``mma.sync`` and SM sub-core (one block of 16 warps on every SM, 4 warps a
sub-core, ``clock64`` around the loop):

  * ``rate``: independent instructions from registers, 8 accumulators a warp:
    TF32 m16n8k8 (what K4 issues), BF16 m16n8k16 and TF32 m16n8k4; and
    ``latency``: one warp, one accumulator, each instruction waiting for the
    one before;
  * ``loop``: the inner loop of K4's ``g·Wᵀ`` product (``kpconv_bwd_x_kernel``
    phase A, the forward's phase 2 alike): 3×TF32 with both operands read from
    shared memory and split hi/lo in registers, 16 queries × 4 tiles of 8 rows
    a warp, 4 k-steps, with and without the run-time test of each tile, and
    with W's fragments read already split.

The kernels' own cycle counters (``kpconv_variants --cycles``) say what a
phase takes; this says what the tensor cores would allow.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

from mvkpconv_tpu_torch.ops import _build

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KIND 0: TF32 m16n8k8, 1: BF16 m16n8k16, 2: TF32 m16n8k4
template <int NACC, int KIND>
__global__ void __launch_bounds__(512, 1) rate(int iters, float* out, long long* cycles) {
  float c[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int r = 0; r < 4; ++r) c[i][r] = 0.f;
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, 0x3f800000u, 0x3f000000u};
  unsigned b0 = 0x3f800000u + threadIdx.x, b1 = 0x3f000000u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      if (KIND == 0)
        mma_tf32(c[i], a, b0, b1);
      else if (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(b0));
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < NACC; ++i)
    for (int r = 0; r < 4; ++r) s += c[i][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

constexpr int LDG = 36, LDW = 36, LDW2 = 72;
// TEST: the run-time test of each tile; PRESPLIT: W read as {hi, lo} pairs
template <bool TEST, bool PRESPLIT>
__global__ void __launch_bounds__(512, 1) loop(int iters, int tiles, float* out, long long* cycles) {
  extern __shared__ float smem[];
  float* gs = smem;             // 64 x 36
  float* ws = smem + 64 * LDG;  // 128 rows
  for (int i = threadIdx.x; i < 64 * LDG + 128 * LDW2; i += 512) smem[i] = 1.f + 1e-3f * (i % 97);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane >> 2, tig = lane & 3;
  const int wr = warp / 4, wc = warp % 4;
  float acc[4][4] = {}, acs[4][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const float* a_ptr = gs + (wr * 16 + g8) * LDG + tig;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned a_hi[4], a_lo[4];
      split(a_ptr[ks * 8], a_hi[0], a_lo[0]);
      split(a_ptr[8 * LDG + ks * 8], a_hi[1], a_lo[1]);
      split(a_ptr[ks * 8 + 4], a_hi[2], a_lo[2]);
      split(a_ptr[8 * LDG + ks * 8 + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tile = wc + 4 * i;
        if (TEST && tile >= tiles) continue;
        unsigned b_hi[2], b_lo[2];
        if (PRESPLIT) {
          const float* b_ptr = ws + (tile * 8 + g8) * LDW2 + 2 * (ks * 8 + tig);
          const uint2 b0 = *reinterpret_cast<const uint2*>(b_ptr), b1 = *reinterpret_cast<const uint2*>(b_ptr + 8);
          b_hi[0] = b0.x, b_lo[0] = b0.y, b_hi[1] = b1.x, b_lo[1] = b1.y;
        } else {
          const float* b_ptr = ws + (tile * 8 + g8) * LDW + ks * 8 + tig;
          split(b_ptr[0], b_hi[0], b_lo[0]);
          split(b_ptr[4], b_hi[1], b_lo[1]);
        }
        mma_tf32(acs[i], a_lo, b_hi[0], b_hi[1]);
        mma_tf32(acs[i], a_hi, b_lo[0], b_lo[1]);
        mma_tf32(acc[i], a_hi, b_hi[0], b_hi[1]);
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 4; ++r) s += acc[i][r] + acs[i][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

float* out;
long long* cyc;

long long read_cycles() {
  cudaDeviceSynchronize();
  long long h = 0;
  cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
  return h;
}

template <int NACC, int KIND>
void run_rate(const char* what, const char* name, int threads) {
  const int iters = 20000;
  for (int rep = 0; rep < 2; ++rep) rate<NACC, KIND><<<132, threads>>>(iters, out, cyc);
  const long long h = read_cycles();
  // a warp's dependent instructions: cycles each; else cycles per instruction and sub-core
  const double per = threads == 32 ? h / (double(iters) * NACC) : h / (double(iters) * NACC * (threads / 32) / 4);
  printf("{\"measure\": \"%s\", \"mma\": \"%s\", \"warps\": %d, \"accumulators\": %d, \"cycles_per_mma\": %.2f, \"error\": \"%s\"}\n",
         what, name, threads / 32, NACC, per, cudaGetErrorString(cudaGetLastError()));
}

template <bool TEST, bool PRESPLIT>
void run_loop(const char* name) {
  const int iters = 2000;
  const size_t bytes = (64 * LDG + 128 * LDW2) * 4;
  cudaFuncSetAttribute(loop<TEST, PRESPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  for (int rep = 0; rep < 2; ++rep) loop<TEST, PRESPLIT><<<132, 512, bytes>>>(iters, 16, out, cyc);
  const long long h = read_cycles();
  printf("{\"measure\": \"loop\", \"variant\": \"%s\", \"warps\": 16, \"cycles_per_mma\": %.2f, \"error\": \"%s\"}\n", name,
         h / (double(iters) * 48 * 4), cudaGetErrorString(cudaGetLastError()));
}

int main() {
  cudaMalloc(&out, 132 * 512 * 4);
  cudaMalloc(&cyc, 8);
  run_rate<8, 0>("rate", "tf32 m16n8k8", 512);
  run_rate<2, 0>("rate", "tf32 m16n8k8", 512);
  run_rate<8, 1>("rate", "bf16 m16n8k16", 512);
  run_rate<8, 2>("rate", "tf32 m16n8k4", 512);
  run_rate<1, 0>("latency", "tf32 m16n8k8", 32);
  run_rate<1, 1>("latency", "bf16 m16n8k16", 32);
  run_rate<1, 2>("latency", "tf32 m16n8k4", 32);
  run_loop<false, false>("split in registers");
  run_loop<true, false>("split in registers, each tile tested");
  run_loop<false, true>("W read split");
  run_loop<true, true>("W read split, each tile tested");
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def main() -> None:
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate"
        src.write_text(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe), str(src)],
                       check=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
        print(f'{{"card": "{smi}"}}', flush=True)
        subprocess.run([str(exe)], check=True)


if __name__ == "__main__":
    main()
