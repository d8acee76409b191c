// Segment sum of gather cotangent rows by target row: the VJP of group_points.
//
// Replaces: mvkpconv_tpu/ops/pallas/segsum.py, banded_window_segsum (kernel
// body _kernel, driven by mvkpconv_tpu/ops/gather.py:_transpose_banded). For
// rows (B*Nq*K, C) and their targets index (B, Nq, K) in [0, Ns),
//   out[b, t, :] = sum of rows[(b, q, k), :] over index[b, q, k] == t,
// accumulated in f32 from f32 or bf16 rows. Rows aimed at the last source
// row (t == Ns-1, the shadow row that pad_shadow_row appends) are summed per
// block in shared memory and reach the output once per block. At the bench
// shapes every short neighbor list and every padded query points at that
// one row, so unreduced it would be tens of thousands of atomics on a
// single address per batch element.
//
// What bounds it on the H100: the rows are read once (1.97M x 32 x 4 B =
// 252 MB at the level-0 resnetb site, ~0.08 ms at 3.35 TB/s) and each one
// lands as atomic adds into an f32 output that fits in the 50 MB L2 (at
// most 65,536 x 66 x 4 B = 17 MB at the widest level-0 site). So it is
// bound by HBM reads and by L2 atomic throughput.
//
// Design (the simple one that is right; no band or MXU tricks, which exist
// for the TPU's VMEM and sequential grid): a thread takes one V-wide channel
// chunk of a row at a time, so consecutive threads read consecutive
// addresses of the row-major rows (coalesced 16-, 8- or 4-byte loads, V = 4,
// 2 or 1 as C and the pointers' alignment allow), convert bf16 to f32 in
// registers, and add into the output with one vector atomic (Hopper's
// float4 / float2 atomicAdd on global memory), or into the block's shadow
// partial sum. Blocks run in no order; the atomics make the
// sum's order, and so its last bits, vary from run to run. A shared-memory
// band accumulation over voxel-sorted targets, or a deterministic two-pass
// design, is later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 12288;

template <typename T, int V>
struct Load;

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct Load<float, 2> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[2]) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  }
};

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

template <>
struct Load<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[2]) {
    const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    v[0] = x.x; v[1] = x.y;
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <int V>
__device__ __forceinline__ void atomic_add(float* p, const float (&v)[V]);

template <>
__device__ __forceinline__ void atomic_add<4>(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <>
__device__ __forceinline__ void atomic_add<2>(float* p, const float (&v)[2]) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

template <>
__device__ __forceinline__ void atomic_add<1>(float* p, const float (&v)[1]) {
  atomicAdd(p, v[0]);
}

// Blocks are laid out (blocks_per_b, B): each block walks its batch
// element's (row, V-chunk) items with a grid stride, items numbered
// row-major so that consecutive threads read consecutive addresses. A row
// aimed at the shadow row (t == ns - 1) goes into this block's partial sum in
// shared memory (c floats, shared atomics), which the block adds to the
// output once at its end: one global atomic per channel per block that saw
// such a row, instead of one per row on a single address.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ rows, const int* __restrict__ index,
              float* __restrict__ out, unsigned int items_per_b,
              unsigned int chunks, unsigned int rows_per_b, int ns, int c) {
  extern __shared__ float shadow[];
  for (int j = threadIdx.x; j < c; j += kThreads) shadow[j] = 0.f;
  __syncthreads();
  const unsigned int b = blockIdx.y;
  const T* rows_b = rows + static_cast<size_t>(b) * rows_per_b * c;
  const int* index_b = index + static_cast<size_t>(b) * rows_per_b;
  float* out_b = out + static_cast<size_t>(b) * ns * c;
  int saw_shadow = 0;
  for (unsigned int i = blockIdx.x * kThreads + threadIdx.x; i < items_per_b;
       i += gridDim.x * kThreads) {
    const unsigned int r = i / chunks;
    const int j = static_cast<int>(i - r * chunks) * V;
    const int t = __ldg(index_b + r);
    // out-of-range targets cannot come from a forward gather, and are
    // skipped rather than written
    if (static_cast<unsigned int>(t) >= static_cast<unsigned int>(ns)) continue;
    float v[V];
    Load<T, V>::run(rows_b + static_cast<size_t>(r) * c + j, v);
    if (t == ns - 1) {
      saw_shadow = 1;
#pragma unroll
      for (int e = 0; e < V; ++e) atomicAdd(shadow + j + e, v[e]);
    } else {
      atomic_add<V>(out_b + static_cast<size_t>(t) * c + j, v);
    }
  }
  if (__syncthreads_or(saw_shadow)) {
    float* dst = out_b + static_cast<size_t>(ns - 1) * c;
    for (int j = threadIdx.x; j < c; j += kThreads) atomicAdd(dst + j, shadow[j]);
  }
}

// Enough blocks for about two waves of the H100's 132 SMs at 8 resident
// blocks each, shared among the batch elements; fewer for small inputs.
constexpr unsigned int kTargetBlocks = 2048;

template <typename T, int V>
cudaError_t launch(const void* rows, const int* index, float* out, int b,
                   unsigned int rows_per_b, int ns, int c, cudaStream_t stream) {
  const unsigned int chunks = static_cast<unsigned int>(c / V);
  const unsigned int items_per_b = rows_per_b * chunks;
  const unsigned int cap = kTargetBlocks / b > 0 ? kTargetBlocks / b : 1;
  const unsigned int need = (items_per_b + kThreads - 1) / kThreads;
  const dim3 grid(need < cap ? need : cap, static_cast<unsigned int>(b));
  segsum_kernel<T, V><<<grid, kThreads, c * sizeof(float), stream>>>(
      static_cast<const T*>(rows), index, out, items_per_b, chunks, rows_per_b, ns, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* rows, const int* index, float* out, int b,
                     unsigned int rows_per_b, int ns, int c, cudaStream_t stream) {
  // widest vector that every row start and every output row start allows
  const uintptr_t rp = reinterpret_cast<uintptr_t>(rows);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const size_t es = sizeof(T);
  if (c % 4 == 0 && rp % (4 * es) == 0 && op % 16 == 0)
    return launch<T, 4>(rows, index, out, b, rows_per_b, ns, c, stream);
  if (c % 2 == 0 && rp % (2 * es) == 0 && op % 8 == 0)
    return launch<T, 2>(rows, index, out, b, rows_per_b, ns, c, stream);
  return launch<T, 1>(rows, index, out, b, rows_per_b, ns, c, stream);
}

}  // namespace

// rows: (b * rows_per_b, c) f32 or bf16, row-major; index: (b * rows_per_b)
// int32 targets in [0, ns); out: (b * ns, c) f32, zeroed by the caller.
// The shadow row's partial sums take c floats of shared memory per block,
// so c is at most kMaxC (48 KB, the default dynamic shared memory).
extern "C" int mvkp_segsum(const void* rows, int rows_is_bf16, const int* index,
                           float* out, int b, int rows_per_b, int ns, int c,
                           cudaStream_t stream) {
  if (b <= 0 || rows_per_b <= 0 || c <= 0) return 0;
  const long long n_rows = static_cast<long long>(b) * rows_per_b;
  if (ns <= 0 || c > kMaxC || b > 65535 || n_rows * c >= (1LL << 31) ||
      static_cast<long long>(b) * ns * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int rpb = static_cast<unsigned int>(rows_per_b);
  if (rows_is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(rows, index, out, b, rpb, ns, c, stream));
  return static_cast<int>(dispatch<float>(rows, index, out, b, rpb, ns, c, stream));
}
