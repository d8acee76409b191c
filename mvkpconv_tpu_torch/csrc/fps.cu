// P1: farthest point sampling, one block a cloud.
//
// No TPU kernel is replaced: the JAX package's FPS is a lax.fori_loop
// (mvkpconv_tpu/ops/sampling.py:27-44, farthest_point_sample) that XLA runs
// as one device loop. The port's plain version (ops/kernels/fps.py,
// farthest_point_sample_plain) is an eager loop of one step a centroid, a
// few PyTorch launches each: PointNet++'s four set-abstraction levels take
// 2,720 steps a forward at MVPNet's shapes, which the host cannot launch
// faster than the device idles.
//
// Contract (the plain version's): for (B, N, 3) f32 points, (B, S) int32
// indices; the first is 0; each next one maximises the least d^2 to the
// chosen set, ties to the lowest index; a point with mask 0 reads -inf and
// is never picked while a valid point remains; with S > N index 0 repeats
// once every point is taken. d^2 is ((dx*dx + dy*dy) + dz*dz), each product
// and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), so
// the running minima equal the plain version's bit for bit.
//
// What bounds it on the H100: the work is 9*B*N*S operations over
// 12*B*N bytes read once, far from both rates; a step depends on the step
// before (its centroid is the previous argmax), so the serial chain of S
// block-wide argmax reductions sets the time.
//
// Design: one block of up to 1024 threads a cloud. For N <= 8192 each thread
// keeps its K <= 8 points (indices tid + k*blockDim) and their running
// minima in registers; above that the points are read from device memory and
// the minima kept in a scratch array (K = 0). A step: every thread reads the
// centroid (one broadcast load, L1-resident), updates its minima and takes
// its own (value, index) argmax; a warp reduces by __shfl_xor_sync on the
// pair, the warps' winners meet in shared memory and warp 0 reduces them.
// The larger value wins and a tie goes to the lower index, which is
// torch.argmax's first-maximum rule.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
               int32_t* __restrict__ out, float* __restrict__ scratch, int n, int s) {
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ int chosen;
  const int b = blockIdx.x;
  const float* p = points + static_cast<size_t>(b) * n * 3;
  const uint8_t* m = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  float* dmin_g = scratch ? scratch + static_cast<size_t>(b) * n : nullptr;
  int32_t* o = out + static_cast<size_t>(b) * s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  float x[K > 0 ? K : 1], y[K > 0 ? K : 1], z[K > 0 ? K : 1], dmin[K > 0 ? K : 1];
  unsigned valid = 0;  // bit k: point tid + k*nthreads exists and is not masked
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * nthreads;
      x[k] = y[k] = z[k] = 0.f;
      dmin[k] = __int_as_float(0x7f800000);
      if (i < n) {
        x[k] = p[3 * i];
        y[k] = p[3 * i + 1];
        z[k] = p[3 * i + 2];
        if (!m || m[i]) valid |= 1u << k;
      }
    }
  } else {
    for (int i = tid; i < n; i += nthreads) dmin_g[i] = __int_as_float(0x7f800000);
  }
  if (tid == 0) o[0] = 0;
  int cur = 0;
  for (int step = 1; step < s; ++step) {
    const float cx = p[3 * cur], cy = p[3 * cur + 1], cz = p[3 * cur + 2];
    float bv = -__int_as_float(0x7f800000);
    int bi = INT_MAX;
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = tid + k * nthreads;
        if (i < n) {
          dmin[k] = fminf(dmin[k], sq_dist(x[k], y[k], z[k], cx, cy, cz));
          better(bv, bi, (valid >> k) & 1u ? dmin[k] : -__int_as_float(0x7f800000), i);
        }
      }
    } else {
      for (int i = tid; i < n; i += nthreads) {
        const float d = fminf(dmin_g[i], sq_dist(p[3 * i], p[3 * i + 1], p[3 * i + 2], cx, cy, cz));
        dmin_g[i] = d;
        better(bv, bi, (!m || m[i]) ? d : -__int_as_float(0x7f800000), i);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? warp_val[lane] : -__int_as_float(0x7f800000);
      bi = lane < nwarps ? warp_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        chosen = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    cur = chosen;
  }
}

template <int K>
cudaError_t launch(const float* points, const uint8_t* mask, int32_t* out, float* scratch, int b,
                   int n, int s, int threads, cudaStream_t stream) {
  fps_kernel<K><<<b, threads, 0, stream>>>(points, mask, out, K > 0 ? nullptr : scratch, n, s);
  return cudaGetLastError();
}

// Points per thread the kernel keeps in registers for N points (0: the
// scratch path, N > 8192), and its threads a block.
int plan(int n, int* threads) {
  int k = 1;
  while (k <= 8 && k * kMaxThreads < n) k *= 2;
  if (k > 8) {
    *threads = kMaxThreads;
    return 0;
  }
  const int t = (n + k - 1) / k;
  *threads = k > 1 ? kMaxThreads : ((t + 31) / 32) * 32;
  return k;
}

}  // namespace

extern "C" int mvkp_fps(const float* points, const uint8_t* mask, int32_t* out, float* scratch,
                        int b, int n, int s, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0;
  const int k = plan(n, &threads);
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(points, mask, out, scratch, b, n, s, threads, stream); break;
    case 2: err = launch<2>(points, mask, out, scratch, b, n, s, threads, stream); break;
    case 4: err = launch<4>(points, mask, out, scratch, b, n, s, threads, stream); break;
    case 8: err = launch<8>(points, mask, out, scratch, b, n, s, threads, stream); break;
    default:
      if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<0>(points, mask, out, scratch, b, n, s, threads, stream);
  }
  return static_cast<int>(err);
}
