// P2: PointNet++'s ball query and 3-NN, one pass a search.
//
// No TPU kernel is replaced: the JAX package's ball_query and knn
// (mvkpconv_tpu/ops/neighbors.py) are plain jnp over (B, Nq, Ns) distance
// blocks, no pl.pallas_call. The port's plain versions (ops/kernels/
// pn2_search.py, ball_query_plain / three_nn_plain) build those blocks a
// chunk of queries at a time and select from them with a few PyTorch ops
// each: at MVPNet's shapes (B = 5; SA0 2,048 centroids over 8,192 points,
// FP3 8,192 queries over 2,048 keys) the blocks, their selections and their
// launches took ~10 ms a forward, for two searches whose arithmetic is
// ~1.4 GFLOP.
//
// Contracts (the plain versions', bit for bit). d^2 is the difference form
// ((dx*dx + dy*dy) + dz*dz), d = query - support, each product and sum
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn: no FMA
// contraction), as ops/common.py:difference_sq_dists computes it.
//  - ball query: for (B, Nq, 3) queries and (B, Ns, 3) supports, (B, Nq, k)
//    int32: the first k supports with d^2 < r2 in index order; a row with
//    fewer hits repeats its first hit in the empty slots; a row with none
//    holds Ns throughout. r2 is a host float, passed by value.
//  - 3-NN: (B, Nq, 3) int32 indices and f32 d^2 of the three smallest
//    (d^2, index) pairs, ascending (ties to the lower index); with Ns < 3 the
//    missing slots hold index Ns - 1 at d^2 = inf.
//
// What bounds it on the H100: ~8 f32 operations a pair over 12 bytes a
// point read once, so the operations, at the f32 SIMT rate (67 TFLOP/s):
// ~0.02 ms for both searches of a forward at MVPNet's shapes. Nothing the
// plain versions write to device memory (the d^2 blocks) is needed: here d^2
// lives in registers, and the supports stream through shared memory.
//
// Design: a CTA serves queries of one cloud (blockIdx.y); the cloud's
// supports stream through a shared-memory tile of `tile` points (float4:
// one 16-byte load a point, broadcast or conflict-free), in index order.
//  - ball query: a warp a query. Each step tests 32 supports, a lane each;
//    __ballot_sync of the hits and __popc of the lower lanes' hits place each
//    hit at its index-order slot, written straight to the output row. A
//    warp stops testing once k hits are in (the published CUDA op's early
//    exit); the CTA loads tiles while any of its warps is still short of k
//    (__syncthreads_or), so a CTA whose balls fill early reads no further.
//  - 3-NN: a thread a query, the best three (key, index) pairs in
//    registers. The key is d^2's bit pattern as an unsigned integer: d^2 >= 0
//    orders as its bits do, and an empty slot's key 0xffffffff lies above
//    every d^2 (inf included), so the first three supports always take the
//    slots. Supports come in index order and a candidate enters only below a
//    strictly larger key, so an equal d^2 stays behind the lower index.
//  - The plan (queries a CTA, tile) comes from the shapes alone in Python
//    (pn2_search.ball_query_plan / three_nn_plan): the most queries a CTA
//    that still give the card two CTAs a streaming multiprocessor.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0xffffffffu;  // an empty 3-NN slot's key, above every d^2's bits
constexpr int kMaxTile = 1024;            // pn2_search.MAX_TILE

__device__ __forceinline__ float sq_dist(float4 q, float4 s) {
  const float dx = __fsub_rn(q.x, s.x), dy = __fsub_rn(q.y, s.y), dz = __fsub_rn(q.z, s.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float4 load_point(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
}

// Points [start, start + count) of a (N, 3) cloud into tile[0, count).
__device__ __forceinline__ void load_tile(float4* tile, const float* cloud, int start, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = load_point(cloud + 3LL * (start + i));
}

// grid (ceil(nq / warps), b), block warps * 32 threads, dynamic shared memory
// tile * 16 bytes.
__global__ void ball_query_kernel(const float* __restrict__ query, const float* __restrict__ support,
                                  int32_t* __restrict__ out, int nq, int ns, float r2, int k, int tile) {
  extern __shared__ float4 pts[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool real = q < nq;  // the same for a warp's 32 lanes
  const long long row_id = static_cast<long long>(b) * nq + q;
  const float4 c = real ? load_point(query + 3 * row_id) : make_float4(0.f, 0.f, 0.f, 0.f);
  int32_t* row = out + row_id * k;
  const float* cloud = support + 3LL * b * ns;
  const unsigned below = (1u << lane) - 1u;
  int found = 0, first = ns;
  bool active = real;
  for (int start = 0; start < ns; start += tile) {
    if (!__syncthreads_or(active)) break;  // also: every warp is done with the last tile
    const int count = min(tile, ns - start);
    load_tile(pts, cloud, start, count);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < count; j += 32) {
      const int i = j + lane;
      const bool hit = i < count && sq_dist(c, pts[i]) < r2;
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hits == 0) continue;
      if (found == 0) first = start + j + __ffs(hits) - 1;
      const int slot = found + __popc(hits & below);
      if (hit && slot < k) row[slot] = start + i;
      found += __popc(hits);
      if (found >= k) break;
    }
    active = found < k;
  }
  if (real)
    for (int s = min(found, k) + lane; s < k; s += 32) row[s] = first;
}

// grid (ceil(nq / threads), b), block threads, dynamic shared memory tile * 16 bytes.
__global__ void three_nn_kernel(const float* __restrict__ query, const float* __restrict__ support,
                                int32_t* __restrict__ idx, float* __restrict__ dist, int nq, int ns, int tile) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = q < nq;
  const long long row_id = static_cast<long long>(b) * nq + q;
  const float4 c = real ? load_point(query + 3 * row_id) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* cloud = support + 3LL * b * ns;
  unsigned k0 = kEmpty, k1 = kEmpty, k2 = kEmpty;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int start = 0; start < ns; start += tile) {
    const int count = min(tile, ns - start);
    __syncthreads();  // every thread is done with the last tile
    load_tile(pts, cloud, start, count);
    __syncthreads();
    if (!real) continue;
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const unsigned key = __float_as_uint(sq_dist(c, pts[j]));
      if (key < k2) {
        const int i = start + j;
        if (key < k1) {
          k2 = k1;
          i2 = i1;
          if (key < k0) {
            k1 = k0;
            i1 = i0;
            k0 = key;
            i0 = i;
          } else {
            k1 = key;
            i1 = i;
          }
        } else {
          k2 = key;
          i2 = i;
        }
      }
    }
  }
  if (!real) return;
  const float inf = __int_as_float(0x7f800000);
  int32_t* o = idx + row_id * 3;
  float* d = dist + row_id * 3;
  o[0] = i0;  // ns >= 1 (the wrapper's check)
  d[0] = __uint_as_float(k0);
  o[1] = ns > 1 ? i1 : ns - 1;
  d[1] = ns > 1 ? __uint_as_float(k1) : inf;
  o[2] = ns > 2 ? i2 : ns - 1;
  d[2] = ns > 2 ? __uint_as_float(k2) : inf;
}

bool plan_ok(int b, int nq, int threads, int tile) {
  return b > 0 && b <= 65535 && nq > 0 && threads >= 32 && threads <= 1024 && threads % 32 == 0 && tile >= 1 &&
         tile <= kMaxTile;
}

}  // namespace

// warps: queries a CTA (a warp each); tile: supports a shared-memory tile
// (pn2_search.ball_query_plan). k >= 1; r2 by value.
extern "C" int mvkp_ball_query(const float* query, const float* support, int32_t* out, int b, int nq, int ns,
                               float r2, int k, int warps, int tile, cudaStream_t stream) {
  if (b == 0 || nq == 0) return 0;
  if (!plan_ok(b, nq, warps * 32, tile) || ns < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + warps - 1) / warps, b);
  ball_query_kernel<<<grid, warps * 32, tile * sizeof(float4), stream>>>(query, support, out, nq, ns, r2, k, tile);
  return static_cast<int>(cudaGetLastError());
}

// threads: queries a CTA (a thread each); tile: supports a shared-memory tile
// (pn2_search.three_nn_plan). ns >= 1.
extern "C" int mvkp_three_nn(const float* query, const float* support, int32_t* idx, float* dist, int b, int nq,
                             int ns, int threads, int tile, cudaStream_t stream) {
  if (b == 0 || nq == 0) return 0;
  if (!plan_ok(b, nq, threads, tile) || ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + threads - 1) / threads, b);
  three_nn_kernel<<<grid, threads, tile * sizeof(float4), stream>>>(query, support, idx, dist, nq, ns, tile);
  return static_cast<int>(cudaGetLastError());
}
