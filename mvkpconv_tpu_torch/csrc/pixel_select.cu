// Exact projective pixel k-NN selection for the 2D -> 3D lift.
//
// Replaces: mvkpconv_tpu/ops/pallas/pixel_select.py, pixel_topk_indices
// (kernel body _kernel). For each 3D point, the k nearest of its V*window^2
// candidate pixels (a window around its projection in every view), ties to
// the lower view-major slot, decoded to flat V*H*W pixel indices. The TPU
// kernel packs slots into the f32 mantissa (2^-14 distance quantization) and
// reads im2col candidate rows; this one is exact and reads the windows
// straight from image_xyz.
//
// What bounds it on the H100: per point, V*window^2 = 245 candidates (bench
// shape) of 3 values each from image_xyz (2.3 MB in bf16 at bench shapes,
// which stays in L2), a d^2 and a comparison each: 16M candidates, far from
// any bound of bytes or operations. What limits a kernel is how many loads it
// issues and how many separate cache lines they touch, and its instructions.
// One thread per point, walking its 245 candidates alone with 735 scalar
// 2-byte loads, made every warp-wide load touch 32 unrelated windows.
//
// Design: G = kLanes lanes a point (MVKP_K2_LANES, 2 unless the build says
// otherwise; chosen by tools/k3_k2_variants.py). Lane j of the group takes
// the window rows j, j + G, ... of the point's V * window rows, view-major. A
// row is read in segments of up to kSeg pixels: the 16-byte pieces of image
// memory that hold the segment (at most 4 in bf16, 7 in f32, each holding at
// least one of its bytes) are loaded whole and shifted in registers by the
// segment's offset in its first piece (whole words by two selects, then a
// half word by a funnel shift in bf16), so a window row of 7 bf16 pixels
// costs 3 or 4 16-byte loads where it cost 21 2-byte ones. Each lane keeps
// the best KCAP (d^2, flat index) pairs of its rows in registers as a sorted
// list (a candidate enters by one unrolled compare-swap pass); the group's
// lists are merged by __shfl_xor_sync within the group, each lane inserting
// its partner's pairs into its own, which leaves every lane with the group's
// best KCAP. The flat index (iv0+dv)*W + iu0+du + v*H*W grows with the slot
// v*window^2 + dv*window + du (du < window <= W), so ordering pairs by (d^2,
// flat index) breaks ties by the lower slot, in whatever order the lanes
// meet them. d^2 is the difference form with explicitly rounded operations
// (no FMA contraction), the same arithmetic as the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#ifndef MVKP_K2_LANES
#define MVKP_K2_LANES 2
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = MVKP_K2_LANES;
static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0, "lanes a point: a power of two <= 32");
constexpr int kSeg = 8;  // pixels of a window row read at once

// A segment of kSeg pixels: kWords 32-bit words of values; it starts at an
// even byte offset (<= 14) in its first 16-byte piece and spans at most
// kChunks pieces.
template <typename T>
struct Seg {
  static constexpr int kWords = 3 * kSeg * static_cast<int>(sizeof(T)) / 4;
  static constexpr int kChunks = (14 + 4 * kWords + 15) / 16;
};

// (d, i) into the sorted list (bd, bi) if it is among its KCAP smallest by
// (d^2, index).
template <int KCAP>
__device__ __forceinline__ void insert(float (&bd)[KCAP], int (&bi)[KCAP], float cd, int ci) {
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

// Element e of a segment shifted to word 0, as f32.
template <typename T, int N>
__device__ __forceinline__ float element(const unsigned (&w)[N], int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const unsigned x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// The npix (<= kSeg) pixels from p into the list, flat indices from flat0.
template <int KCAP, typename T>
__device__ __forceinline__ void scan_segment(const T* p, int npix, int flat0, float qx, float qy, float qz,
                                             float (&bd)[KCAP], int (&bi)[KCAP]) {
  constexpr int kChunks = Seg<T>::kChunks;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* piece = reinterpret_cast<const uint4*>(addr & ~static_cast<uintptr_t>(15));
  const int o = static_cast<int>(addr & 15);
  const int last = (o + npix * 3 * static_cast<int>(sizeof(T)) - 1) >> 4;
  unsigned w[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint4 x = c <= last ? __ldg(piece + c) : make_uint4(0u, 0u, 0u, 0u);
    w[4 * c] = x.x;
    w[4 * c + 1] = x.y;
    w[4 * c + 2] = x.z;
    w[4 * c + 3] = x.w;
  }
  // shift the segment to word 0: by o / 4 words, then (bf16) by half a word
  const bool one = (o & 4) != 0, two = (o & 8) != 0;
#pragma unroll
  for (int i = 0; i < 4 * kChunks - 1; ++i) w[i] = one ? w[i + 1] : w[i];
#pragma unroll
  for (int i = 0; i < 4 * kChunks - 2; ++i) w[i] = two ? w[i + 2] : w[i];
  if constexpr (sizeof(T) == 2) {
    const unsigned half = (o & 2) ? 16u : 0u;
#pragma unroll
    for (int i = 0; i < Seg<T>::kWords; ++i) w[i] = __funnelshift_r(w[i], w[i + 1], half);
  }
#pragma unroll
  for (int du = 0; du < kSeg; ++du) {
    if (du < npix) {
      const float dx = __fsub_rn(element<T>(w, 3 * du), qx);
      const float dy = __fsub_rn(element<T>(w, 3 * du + 1), qy);
      const float dz = __fsub_rn(element<T>(w, 3 * du + 2), qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const int flat = flat0 + du;
      if (d2 < bd[KCAP - 1] || (d2 == bd[KCAP - 1] && flat < bi[KCAP - 1])) insert<KCAP>(bd, bi, d2, flat);
    }
  }
}

template <int KCAP, typename T>
__global__ void __launch_bounds__(kThreads)
pixel_topk_kernel(const float* __restrict__ points, const T* __restrict__ img,
                  const int* __restrict__ iu0, const int* __restrict__ iv0,
                  int* __restrict__ out, int b_n, int n, int nv, int h, int w,
                  int window, int k, unsigned long long magic) {
  constexpr int G = kLanes;
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int pt = static_cast<int>(thread / G);  // the same for the whole group
  if (pt >= b_n) return;
  const int j = static_cast<int>(thread % G);
  const int b = pt / n, p = pt - b * n;
  const float qx = __ldg(points + 3 * static_cast<size_t>(pt));
  const float qy = __ldg(points + 3 * static_cast<size_t>(pt) + 1);
  const float qz = __ldg(points + 3 * static_cast<size_t>(pt) + 2);

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int q = 0; q < KCAP; ++q) {
    bd[q] = __int_as_float(0x7f800000);  // +inf
    bi[q] = INT_MAX;
  }
  const int hw = h * w;
  const T* img_b = img + static_cast<size_t>(b) * nv * hw * 3;
  const int* u0s = iu0 + static_cast<size_t>(b) * nv * n + p;
  const int* v0s = iv0 + static_cast<size_t>(b) * nv * n + p;
  int cur_v = -1, u0 = 0, v0 = 0;
  for (int r = j; r < nv * window; r += G) {
    const int v = static_cast<int>((static_cast<unsigned long long>(r) * magic) >> 32);  // r / window
    if (v != cur_v) {
      cur_v = v;
      u0 = __ldg(u0s + static_cast<size_t>(v) * n);
      v0 = __ldg(v0s + static_cast<size_t>(v) * n);
    }
    const int row = v * hw + (v0 + r - v * window) * w + u0;
    for (int s0 = 0; s0 < window; s0 += kSeg)
      scan_segment<KCAP, T>(img_b + static_cast<size_t>(row + s0) * 3, min(kSeg, window - s0), row + s0, qx, qy, qz,
                            bd, bi);
  }
  if constexpr (G > 1) {
    // merge the group's lists: after log2(G) exchanges every lane of the
    // group holds its best KCAP
    const unsigned lane = threadIdx.x & 31;
    const unsigned group = (0xffffffffu >> (32 - G)) << (lane & ~static_cast<unsigned>(G - 1));
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      float pd[KCAP];
      int pi[KCAP];
#pragma unroll
      for (int q = 0; q < KCAP; ++q) {
        pd[q] = __shfl_xor_sync(group, bd[q], off, G);
        pi[q] = __shfl_xor_sync(group, bi[q], off, G);
      }
#pragma unroll
      for (int q = 0; q < KCAP; ++q) {
        if (!(pd[q] < bd[KCAP - 1] || (pd[q] == bd[KCAP - 1] && pi[q] < bi[KCAP - 1]))) break;
        insert<KCAP>(bd, bi, pd[q], pi[q]);
      }
    }
  }
  if (j == 0) {
    int* o = out + static_cast<size_t>(pt) * k;
#pragma unroll
    for (int q = 0; q < KCAP; ++q) {
      if (q < k) o[q] = bi[q];
    }
  }
}

template <int KCAP, typename T>
cudaError_t launch(const float* points, const void* img, const int* iu0,
                   const int* iv0, int* out, int b, int n, int nv, int h,
                   int w, int window, int k, cudaStream_t stream) {
  const long long threads = static_cast<long long>(b) * n * kLanes;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const unsigned long long magic = ((1ull << 32) + window - 1) / window;
  pixel_topk_kernel<KCAP, T><<<grid, kThreads, 0, stream>>>(
      points, static_cast<const T*>(img), iu0, iv0, out, b * n, n, nv, h, w, window, k, magic);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* points, const void* img, const int* iu0,
                     const int* iv0, int* out, int b, int n, int nv, int h,
                     int w, int window, int k, cudaStream_t stream) {
  if (k <= 1) return launch<1, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 3) return launch<3, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 8) return launch<8, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 16) return launch<16, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  return launch<32, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
}

}  // namespace

// points (b, n, 3) f32; img (b, nv, h, w, 3) f32 or bf16; iu0, iv0 (b, nv, n)
// int32 window corners in bounds; out (b, n, k) int32.
extern "C" int mvkp_pixel_topk(const float* points, const void* img,
                               int img_is_bf16, const int* iu0, const int* iv0,
                               int* out, int b, int n, int nv, int h, int w,
                               int window, int k, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return 0;
  if (k <= 0 || k > 32 || k > nv * window * window || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      img_is_bf16
          ? dispatch<__nv_bfloat16>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream)
          : dispatch<float>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  return static_cast<int>(err);
}
