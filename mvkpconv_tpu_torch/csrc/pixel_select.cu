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
// shape) of 3 values each, i.e. 2.9 KB read in f32 (1.5 KB in bf16) from
// image_xyz, which is 4.6 MB at bench shapes in f32 and stays in L2. The
// reads are short row segments (3*window contiguous values per window row),
// so the kernel is bound by L2/L1 load transactions, not by arithmetic or
// device-memory bandwidth.
//
// Design: one thread per point. The best KCAP (d^2, flat index) pairs live
// in registers as a sorted list; a candidate enters by one unrolled
// compare-swap pass. The flat index (iv0+dv)*W + iu0+du + v*H*W grows with
// the slot v*window^2 + dv*window + du (du < window <= W), so breaking ties
// by the lower flat index is breaking them by the lower slot. d^2 is the
// difference form with explicitly rounded operations (no FMA contraction),
// the same arithmetic as the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_coord(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_coord(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int KCAP, typename T>
__global__ void __launch_bounds__(kThreads)
pixel_topk_kernel(const float* __restrict__ points, const T* __restrict__ img,
                  const int* __restrict__ iu0, const int* __restrict__ iv0,
                  int* __restrict__ out, int n, int nv, int h, int w,
                  int window, int k) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float* qp = points + (static_cast<size_t>(b) * n + p) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bi[j] = INT_MAX;
  }

  const int hw = h * w;
  for (int v = 0; v < nv; ++v) {
    const size_t anchor = (static_cast<size_t>(b) * nv + v) * n + p;
    const int u0 = iu0[anchor];
    const int v0 = iv0[anchor];
    const T* view = img + (static_cast<size_t>(b) * nv + v) * hw * 3;
    for (int dv = 0; dv < window; ++dv) {
      const int row = (v0 + dv) * w + u0;
      for (int du = 0; du < window; ++du) {
        const T* c = view + static_cast<size_t>(row + du) * 3;
        const float dx = __fsub_rn(load_coord(c), qx);
        const float dy = __fsub_rn(load_coord(c + 1), qy);
        const float dz = __fsub_rn(load_coord(c + 2), qz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d2 < bd[KCAP - 1]) {
          float cd = d2;
          int ci = v * hw + row + du;
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
  }
  int* o = out + (static_cast<size_t>(b) * n + p) * k;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    if (j < k) o[j] = bi[j];
  }
}

template <int KCAP, typename T>
cudaError_t launch(const float* points, const void* img, const int* iu0,
                   const int* iv0, int* out, int b, int n, int nv, int h,
                   int w, int window, int k, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  pixel_topk_kernel<KCAP, T><<<grid, kThreads, 0, stream>>>(
      points, static_cast<const T*>(img), iu0, iv0, out, n, nv, h, w, window, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* points, const void* img, const int* iu0,
                     const int* iv0, int* out, int b, int n, int nv, int h,
                     int w, int window, int k, cudaStream_t stream) {
  if (k <= 1) return launch<1, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 4) return launch<4, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 8) return launch<8, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  if (k <= 16) return launch<16, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
  return launch<32, T>(points, img, iu0, iv0, out, b, n, nv, h, w, window, k, stream);
}

}  // namespace

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
