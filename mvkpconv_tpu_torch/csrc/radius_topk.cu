// Exact radius top-k neighbor selection for the input pyramid.
//
// Replaces: mvkpconv_tpu/ops/pallas/radius_topk.py, binmin_radius_topk
// (kernel body _kernel). For each query, the up-to-k nearest supports with
// d^2 < r^2, ascending by d^2, ties to the lower support index, missing
// slots padded with Ns. Unlike the TPU kernel there are no 128 lane bins,
// no 2^-9 distance quantization and no Ns <= 2^14 limit: the selection is
// exact.
//
// What bounds it on the H100: the brute-force sweep is Nq*Ns distance
// evaluations (4*16384*16384 = 1.1e9 at level 0 of the bench config), about
// ten instructions each; the bytes are tiny (supports are read once per
// block of queries). So it is bound by instruction issue on the SMs.
//
// Design: one thread per query, 128 queries per block. Supports are staged
// through shared memory in tiles of 1024 (x, y, z, pad) float4s, so every
// thread of a warp reads the same support with one broadcast load. Each
// thread keeps a sorted list of its best KCAP (d^2, index) pairs in
// registers (KCAP is the smallest instantiated capacity >= k; the first k
// entries of a sorted top-KCAP list are the top-k). A candidate is tested
// against the list's last entry and inserted by one unrolled compare-swap
// pass, so the list never leaves registers. d^2 is the difference form with
// explicitly rounded operations (no FMA contraction), the same arithmetic as
// the plain PyTorch version, so both select the same supports.
// Skipping support tiles by their sorted x range is later speed work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
radius_topk_kernel(const float* __restrict__ query,
                   const float* __restrict__ support, int* __restrict__ out,
                   int nq, int ns, float r2, int k) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < nq;
  const float* qp = query + (static_cast<size_t>(b) * nq + (active ? q : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* sp = support + static_cast<size_t>(b) * ns * 3;

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    bd[j] = r2;  // only d^2 < r^2 can enter
    bi[j] = ns;  // shadow index for slots never filled
  }

  for (int base = 0; base < ns; base += kTile) {
    const int n = min(kTile, ns - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* s = sp + static_cast<size_t>(base + t) * 3;
      tile[t] = make_float4(s[0], s[1], s[2], 0.f);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float4 s = tile[t];
      const float dx = __fsub_rn(qx, s.x);
      const float dy = __fsub_rn(qy, s.y);
      const float dz = __fsub_rn(qz, s.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      // supports arrive in ascending index order, so a candidate that ties
      // the last entry ranks after it and is rejected
      if (d2 < bd[KCAP - 1]) {
        float cd = d2;
        int ci = base + t;
#pragma unroll
        for (int j = 0; j < KCAP; ++j) {
          const bool before = cd < bd[j] || (cd == bd[j] && ci < bi[j]);
          if (before) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = cd;
            bi[j] = ci;
            cd = td;
            ci = ti;
          }
        }
      }
    }
  }
  if (active) {
    int* o = out + (static_cast<size_t>(b) * nq + q) * k;
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (j < k) o[j] = bi[j];
    }
  }
}

template <int KCAP>
cudaError_t launch(const float* query, const float* support, int* out, int b,
                   int nq, int ns, float r2, int k, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  radius_topk_kernel<KCAP><<<grid, kThreads, 0, stream>>>(query, support, out,
                                                         nq, ns, r2, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mvkp_radius_topk(const float* query, const float* support,
                                int* out, int b, int nq, int ns, float r2,
                                int k, cudaStream_t stream) {
  if (b <= 0 || nq <= 0) return 0;
  if (k <= 0 || k > 128 || ns <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k <= 1) err = launch<1>(query, support, out, b, nq, ns, r2, k, stream);
  else if (k <= 4) err = launch<4>(query, support, out, b, nq, ns, r2, k, stream);
  else if (k <= 8) err = launch<8>(query, support, out, b, nq, ns, r2, k, stream);
  else if (k <= 16) err = launch<16>(query, support, out, b, nq, ns, r2, k, stream);
  else if (k <= 32) err = launch<32>(query, support, out, b, nq, ns, r2, k, stream);
  else if (k <= 64) err = launch<64>(query, support, out, b, nq, ns, r2, k, stream);
  else err = launch<128>(query, support, out, b, nq, ns, r2, k, stream);
  return static_cast<int>(err);
}
