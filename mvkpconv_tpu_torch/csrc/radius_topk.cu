// Exact radius top-k neighbor selection for the input pyramid.
//
// Replaces: mvkpconv_tpu/ops/pallas/radius_topk.py, binmin_radius_topk
// (kernel body _kernel). For each query, the up-to-k nearest supports with
// d^2 < r^2, ascending by d^2, ties to the lower support index, missing
// slots padded with Ns. Unlike the TPU kernel there are no 128 lane bins,
// no 2^-9 distance quantization and no Ns <= 2^14 limit: the selection is
// exact, for points in any order.
//
// What bounds it on the H100: the bytes are tiny and the function's own work
// is a d^2 for the few supports within the radius (35 of 16384 at level 0 of
// the bench configuration), so the time is whatever the search spends on
// supports that are out of range, in instructions executed. The design is
// about not looking at them, and about keeping every lane busy when it does
// look.
//
// Design.
//   Boxes. The levels arrive sorted by voxel (x-major), so 32 consecutive
//   supports are compact in x and y. A pre-pass kernel writes, per group of
//   32 supports, their bounding box, per super-group of 32 groups the box of
//   the boxes, and the supports repacked as float4 (one 16-byte load a
//   lane). The boxes are taken from the data: on unsorted input they are
//   large, nothing is skipped, and the result is the same.
//   A warp per query. Its lanes test 32 super-group boxes at once, then the
//   32 group boxes of each super-group that is kept, then take one support
//   each of every group that is kept. Skipping is the warp's decision, there
//   is no per-thread divergence, and 4 x 256 queries still make 1024 warps.
//   The skip test is conservative by construction, with no margin: per axis
//   gap = max(lo - q, q - hi, 0) is a lower bound of |q - s| as __fsub_rn
//   rounds it for every s in the box (rounding is monotone and symmetric),
//   and the squares and their sum are rounded by the same operations in the
//   same order as d^2, which are monotone in each non-negative argument; so
//   the bound never exceeds the rounded d^2 of any pair, and a group is
//   skipped only when bound >= r^2. Padded rows (1e6) give gaps of 1e6 and
//   squares of 1e12: finite. A lane past the end of the last group repeats
//   the group's first point, so no box ever holds inf.
//   The list. In-range candidates are 64-bit keys (d^2 bits, index): d^2 >= 0,
//   so the bits order like the value, and the index breaks ties whatever the
//   order of the visit. Lanes append their hits to the warp's buffer in
//   shared memory by ballot and prefix count. When a batch would overflow
//   the buffer, and at the end, the buffer is ordered once by rank: each lane
//   counts, for its entries, the keys below them (the keys are distinct, so
//   the ranks are a permutation) and writes those of rank < k to their place.
//   After an overflow the k-th key becomes the bar for later candidates, so
//   any number of supports within the radius stays exact. k = 1 (the
//   upsample) keeps no buffer: a running minimum per lane, reduced at the end.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kGroup = 32;  // supports per group: one per lane
constexpr int kSuper = 32;  // groups per super-group: one box test per lane
constexpr int kWarps = 8;   // queries per block
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNone = ~0ull;

// Lower bound of the rounded d^2 between q and any point of the box [lo, hi].
// ops/kernels/radius_topk.py:box_lower_bound mirrors it operation by operation.
__device__ __forceinline__ float lower_bound_d2(float qx, float qy, float qz, float4 lo,
                                                float4 hi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

__device__ __forceinline__ void warp_box(float4& lo, float4& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(kFull, lo.x, o));
    lo.y = fminf(lo.y, __shfl_xor_sync(kFull, lo.y, o));
    lo.z = fminf(lo.z, __shfl_xor_sync(kFull, lo.z, o));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(kFull, hi.x, o));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(kFull, hi.y, o));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(kFull, hi.z, o));
  }
}

// Pre-pass. Block (sg, b): the super-group sg of batch element b, a warp per
// group. boxes[(b * groups + g) * 2 + {0, 1}] = {lo, hi}; super_boxes alike.
__global__ void __launch_bounds__(kSuper * 32)
radius_boxes_kernel(const float* __restrict__ support, float4* __restrict__ packed,
                    float4* __restrict__ boxes, float4* __restrict__ super_boxes, int ns,
                    int groups, int supers) {
  __shared__ float4 lo_s[kSuper], hi_s[kSuper];
  const int b = blockIdx.y, sg = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = sg * kSuper + warp;
  const float* sp = support + static_cast<size_t>(b) * ns * 3;
  if (g < groups) {
    const int i = g * kGroup + lane;
    const int src = i < ns ? i : g * kGroup;  // past the end: the group's first point
    const float x = sp[3 * static_cast<size_t>(src)];
    const float y = sp[3 * static_cast<size_t>(src) + 1];
    const float z = sp[3 * static_cast<size_t>(src) + 2];
    if (i < ns) packed[static_cast<size_t>(b) * ns + i] = make_float4(x, y, z, 0.f);
    float4 lo = make_float4(x, y, z, 0.f), hi = lo;
    warp_box(lo, hi);
    if (lane == 0) {
      lo_s[warp] = lo;
      hi_s[warp] = hi;
      boxes[(static_cast<size_t>(b) * groups + g) * 2] = lo;
      boxes[(static_cast<size_t>(b) * groups + g) * 2 + 1] = hi;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int src = sg * kSuper + lane < groups ? lane : 0;  // group sg * 32 exists
    float4 lo = lo_s[src], hi = hi_s[src];
    warp_box(lo, hi);
    if (lane == 0) {
      super_boxes[(static_cast<size_t>(b) * supers + sg) * 2] = lo;
      super_boxes[(static_cast<size_t>(b) * supers + sg) * 2 + 1] = hi;
    }
  }
}

// Orders the warp's buffer by rank and keeps the first min(count, k) keys,
// ascending, in buf[0 ..]; returns how many.
template <int CAP>
__device__ __forceinline__ int select_lowest(u64* buf, int count, int k, int lane) {
  constexpr int E = CAP / 32;
  u64 mine[E];
  int rank[E];
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + 32 * e;
    mine[e] = i < count ? buf[i] : kNone;
    rank[e] = 0;
  }
  const int ne = (count + 31) / 32;
  for (int j = 0; j < count; ++j) {
    const u64 kj = buf[j];
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < ne) rank[e] += kj < mine[e];
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < count && rank[e] < k) buf[rank[e]] = mine[e];
  __syncwarp();
  return min(count, k);
}

// A warp per query. CAP: keys the warp's buffer holds (>= k + 32); 0 for k = 1.
template <int CAP>
__global__ void __launch_bounds__(kWarps * 32)
radius_topk_kernel(const float* __restrict__ query, const float4* __restrict__ packed,
                   const float4* __restrict__ boxes, const float4* __restrict__ super_boxes,
                   int* __restrict__ out, int nq, int ns, int groups, int supers, float r2,
                   int k) {
  __shared__ u64 buf_s[CAP > 0 ? kWarps * CAP : 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= nq) return;  // the whole warp; the block never synchronises
  const float* qp = query + (static_cast<size_t>(b) * nq + q) * 3;
  const float qx = __ldg(qp), qy = __ldg(qp + 1), qz = __ldg(qp + 2);
  const float4* pk = packed + static_cast<size_t>(b) * ns;
  const float4* bx = boxes + static_cast<size_t>(b) * groups * 2;
  const float4* sb = super_boxes + static_cast<size_t>(b) * supers * 2;
  u64* buf = buf_s + warp * (CAP > 0 ? CAP : 0);
  int count = 0;
  u64 bar = kNone;   // a candidate must be below it
  u64 best = kNone;  // k = 1: this lane's lowest key

  for (int s0 = 0; s0 < supers; s0 += 32) {
    const int s = s0 + lane;
    bool keep = s < supers &&
                lower_bound_d2(qx, qy, qz, __ldg(sb + 2 * s), __ldg(sb + 2 * s + 1)) < r2;
    unsigned ms = __ballot_sync(kFull, keep);
    while (ms) {
      const int sg = s0 + __ffs(ms) - 1;
      ms &= ms - 1;
      const int g = sg * kSuper + lane;
      keep = g < groups &&
             lower_bound_d2(qx, qy, qz, __ldg(bx + 2 * g), __ldg(bx + 2 * g + 1)) < r2;
      unsigned mg = __ballot_sync(kFull, keep);
      while (mg) {
        const int i = (sg * kSuper + __ffs(mg) - 1) * kGroup + lane;
        mg &= mg - 1;
        u64 key = kNone;
        if (i < ns) {
          const float4 p = __ldg(pk + i);
          const float dx = __fsub_rn(qx, p.x);
          const float dy = __fsub_rn(qy, p.y);
          const float dz = __fsub_rn(qz, p.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          if (d2 < r2)
            key = (static_cast<u64>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(i);
        }
        if constexpr (CAP == 0) {
          best = key < best ? key : best;
        } else {
          const bool hit = key < bar;
          const unsigned mh = __ballot_sync(kFull, hit);
          if (mh) {
            const int add = __popc(mh);
            if (count + add > CAP) {
              count = select_lowest<CAP>(buf, count, k, lane);
              // hits of this batch that no longer pass the bar are dropped at the end
              if (count == k) bar = buf[k - 1];
            }
            if (hit) buf[count + __popc(mh & ((1u << lane) - 1u))] = key;
            count += add;
          }
        }
      }
    }
  }

  int* o = out + (static_cast<size_t>(b) * nq + q) * k;
  if constexpr (CAP == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const u64 other = __shfl_xor_sync(kFull, best, off);
      best = other < best ? other : best;
    }
    if (lane == 0) o[0] = best == kNone ? ns : static_cast<int>(best & 0xffffffffu);
  } else {
    count = select_lowest<CAP>(buf, count, k, lane);
    for (int j = lane; j < k; j += 32)
      o[j] = j < count ? static_cast<int>(buf[j] & 0xffffffffu) : ns;
  }
}

template <int CAP>
cudaError_t launch(const float* query, const float4* packed, const float4* boxes,
                   const float4* super_boxes, int* out, int b, int nq, int ns, int groups,
                   int supers, float r2, int k, cudaStream_t stream) {
  const dim3 grid((nq + kWarps - 1) / kWarps, b);
  radius_topk_kernel<CAP><<<grid, kWarps * 32, 0, stream>>>(
      query, packed, boxes, super_boxes, out, nq, ns, groups, supers, r2, k);
  return cudaGetLastError();
}

}  // namespace

// Two launches: the boxes of the supports, then the search. The wrapper
// allocates the scratch: packed (b * ns float4), boxes (b * groups * 2 float4,
// groups = ceil(ns / 32)), super_boxes (b * supers * 2 float4, supers =
// ceil(groups / 32)).
extern "C" int mvkp_radius_topk(const float* query, const float* support, int* out,
                                void* packed, void* boxes, void* super_boxes, int b, int nq,
                                int ns, float r2, int k, cudaStream_t stream) {
  if (b <= 0 || nq <= 0) return 0;
  if (k <= 0 || k > 128 || ns <= 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (ns + kGroup - 1) / kGroup;
  const int supers = (groups + kSuper - 1) / kSuper;
  float4* pk = static_cast<float4*>(packed);
  float4* bx = static_cast<float4*>(boxes);
  float4* sb = static_cast<float4*>(super_boxes);
  radius_boxes_kernel<<<dim3(supers, b), kSuper * 32, 0, stream>>>(support, pk, bx, sb, ns,
                                                                  groups, supers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 1) err = launch<0>(query, pk, bx, sb, out, b, nq, ns, groups, supers, r2, k, stream);
  else if (k <= 96) err = launch<128>(query, pk, bx, sb, out, b, nq, ns, groups, supers, r2, k, stream);
  else err = launch<256>(query, pk, bx, sb, out, b, nq, ns, groups, supers, r2, k, stream);
  return static_cast<int>(err);
}
