// K5: one convolution site of the frozen UNet-ResNet34, with everything around
// that convolution fused into it, float32-exact on the tensor cores.
//
// Replaces no TPU kernel: the JAX UNet (mvkpconv_tpu/models/unet2d.py) is
// flax nn.Conv, which XLA runs. It was added because the port's float32 UNet
// on cuDNN (TF32 off, as the configurations fix it) ran cuDNN's FFT GEMM and
// 2,666 launches a call (25 images of 120x160): about 36 ms of device time,
// and about as long to issue on the host. One launch a site of this kernel
// does the work of the conv, its bias, the eval-mode BN, the residual add,
// the ReLU, the decoder's concat, the input's zero padding and the crop.
//
// Contract (ops/kernels/unet_conv.py, unet_conv_plain), activations NHWC f32:
//   conv:       out[b,oy,ox,n] = act(bn(sum_{c,ky,kx} in[b, oy*s-p+ky, ox*s-p+kx, c] * W[n,c,ky,kx]
//                                       + bias[n]) + res[b,oy,ox,n])
//               in = x (C1 channels) followed by x2 (C2 channels, the decoder's
//               skip); a pixel outside [0,H) x [0,W) reads 0 (the conv's
//               padding, and the zero padding of the image to a multiple of
//               16: the output may be taller than the input allows); the
//               output is OH x OW, which may crop the conv's own size.
//   transposed: 2x2 stride 2, W[c, n, dy, dx] (torch's (in, out, kh, kw)):
//               out[b, 2y+dy, 2x+dx, n] = act(bn(sum_c x[b,y,x,c] W[c,n,dy,dx] + bias[n]))
//   bn(v) = (v - mean[n]) * (rsqrt(var[n] + eps) * weight[n]) + beta[n]  (models/norm.py, eval)
// The weights are read in the module's own layout; nothing derived from
// them is kept between calls.
//
// What bounds it on the H100: operations. A call of the UNet at the bench
// shape is 443 GFLOP (17.7 an image at 128x160) over some 1.4 GB of
// activations read and written once: 6.6 ms at the f32 SIMT peak (67
// TFLOP/s) and 2.7 ms of 3xTF32 at 495/3 TFLOP/s, against 0.4 ms of bytes.
// The 3xTF32 product: each operand v is split in registers into a TF32 hi
// and lo (split_tf32, as K4 does), and lo*hi + hi*lo + hi*hi is accumulated
// in f32 by mma.sync m16n8k8; what is dropped (lo*lo and the lo parts'
// rounding) is below 3 * 2^-22 of each product, so the sums hold float32
// accuracy, not TF32's 2^-11.
//
// Design: an implicit GEMM, M = output pixels (input pixels for the
// transposed conv), N = output channels (4 x for the transposed conv, whose
// epilogue scatters them to the four output phases), K = input channels x
// taps. A block of 4 warps takes BM = 64 or 128 rows x BN = 64 columns (the
// caller's choice from the site's shape and the card's SMs:
// ops/kernels/unet_conv.py plan); a warp holds
// BM/2 x 32 accumulators. The K loop runs over chunks of 16 input channels
// (one source each: C1 and C2 are multiples of 16). A chunk's B tile is the
// whole 16 x KH*KW block of weights of each of its 64 output channels, which
// OIHW keeps contiguous (576 bytes a channel for 3x3), so it comes by
// cp.async in 16-byte pieces once a chunk and serves all its taps from shared
// memory (the fragment of tap t reads every KH*KW-th word; a row stride of
// 16*KH*KW + 4 words keeps those reads free of bank conflicts). The A operand
// comes one of two ways:
//   per tap (kConv): a stage is one (chunk, tap) pair, BM pixels x 16
//   channels (64 contiguous bytes a pixel of NHWC) in 16-byte pieces,
//   zero-filled where the pixel lies outside the image; three A stages and
//   two B chunks in flight, one barrier a stage;
//   by halo (kHalo, 3x3 stride-1 convs on images whose width is a multiple of
//   8): the block's rows are a patch of 16 x 8 output pixels, and a stage is a
//   whole chunk: the patch's 18 x 10 input pixels of 16 channels, from which
//   the 9 taps read their fragments (each tap's 8-pixel rows are consecutive
//   halo rows, so the fragment loads stay free of conflicts); two stages in
//   flight, a ninth of the per-tap path's loads and barriers.
// Fragments come by ldmatrix (A) and 32-bit loads (B), are split into
// hi and lo in registers, and each tap's 16 channels are multiplied into
// fresh sums that are then added to the running ones rounded to nearest
// (the tensor cores round toward zero: over K = 4608 that bias reached 1e-5).
// Where even 128-row tiles leave SMs idle (the deepest sites: 2,000 rows),
// the chunks are cut into 2-3 splits (blocks along z), each writes its sums,
// and unet_conv_finish adds them in split order and applies the epilogue.
// The stem (3 input channels, 7x7) takes the gather mode instead: K is the
// flattened (c, ky, kx) of the weights' own order, loaded 4 bytes an element.
// The epilogue applies the bias, the BN, the residual and the ReLU in
// registers and stores NHWC (the transposed conv through a staging tile, 64
// contiguous bytes an output pixel). The result does not depend on timing: no
// atomics, a fixed order.
//
// Measured (one H100 80GB HBM3 at 700 W, the cells' 25 images): the whole UNet
// in 10.6 ms, 41 TFLOP/s, against 52.5 ms for the module path (cuDNN float32:
// its decoder2 conv alone 22.7 ms, the FFT GEMM). Built, measured and not
// kept: 8-warp blocks (no faster), the three products of a tile issued
// together or term by term (no difference), a flush of the sums every second
// tap (no faster, and K5's error against float64 rose past cuDNN's), the halo
// for images whose width is not a multiple of 8 (the idle columns cost more
// than the loads saved). What it waits for is neither the tensor cores (the
// 3 x TF32 products cost 2.7 ms of the 11.9 they took before the halo) nor
// the copies alone (3 ms): the splits, fragment loads and barriers around them.

#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;        // columns a block
constexpr int kBK = 16;        // input channels (or flattened K) a stage
constexpr int kStages = 3;     // A stages in flight
constexpr int kLdA = kBK + 4;  // A row stride: = 20, conflict-free fragment loads
constexpr int kLdKN = kBN + 8; // transposed conv's B row stride: = 8 mod 32
constexpr int kLdOut = kBN + 4; // transposed conv's staged output row stride

enum Mode { kConv = 0, kGather = 1, kDeconv = 2, kHalo = 3 };

struct Params {
  const float* x;
  const float* x2;
  const float* w;
  const float* bias;
  const float* bn_w;
  const float* bn_b;
  const float* bn_mean;
  const float* bn_var;
  const float* res;
  float* out;
  int H, W, C1, C2;   // input
  int OH, OW;         // the M grid: output pixels (conv) or input pixels (transposed)
  int M, N, cout;     // GEMM rows, columns; output channels
  int KH, KW, stride, pad;
  int T;              // taps a chunk (KH*KW for kConv, 1 otherwise)
  int chunks;         // K chunks
  int ldb;            // B row stride in floats
  int nb;             // B buffers
  int B, tiles_x, tiles_y;  // kHalo: images and output patches along x and y
  float* partial;     // splits > 1: (splits, M, N) sums of each split's chunks
  int splits, cps;    // K splits (blockIdx.z) and chunks a split
  int relu;
  float eps;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo as the tensor cores read them (the upper 19 bits of a register):
// hi is v rounded to nearest there (add half a unit, clear the rest), lo = v -
// hi, exact in f32, |lo| <= 2^-11 |v|; the tensor cores drop lo's low bits,
// less than 2^-21 |v|, which spares the rounding add of K4's split_tf32.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b, the sums starting from zero.
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Four 8x4 tiles of 32-bit words from shared memory, a row address a lane
// (lanes 8j..8j+7: tile j): word (lane / 4, lane % 4) of each tile, which is
// the TF32 A fragment of m16n8k8 when the tiles are rows 0-7 and 8-15 of
// columns 0-3, then of columns 4-7.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A row of the tile: its image's first input pixel (-1 where the row holds no
// output pixel), the input coordinates of tap (0, 0), and its output pixel.
struct RowInfo {
  int base, iy0, ix0, out;
};

// kHalo: a block's rows are a patch of BM / kPatchW x kPatchW output pixels; a
// stage holds the patch's input halo, (BM / kPatchW + 2) x (kPatchW + 2)
// pixels of a chunk's 16 channels, and serves the 9 taps of a 3x3 conv.
constexpr int kPatchW = 8;
template <int BM>
struct Halo {
  static constexpr int H = BM / kPatchW + 2, W = kPatchW + 2, floats = H * W * kLdA;
};

template <int MODE>
__host__ __device__ constexpr int stages_in_flight() {
  return MODE == kHalo ? 2 : kStages;
}

template <int MT, int MODE>
__host__ __device__ constexpr int a_floats() {  // one A stage
  return MODE == kHalo ? Halo<MT * 32>::floats : MT * 32 * kLdA;
}

// 4 warps: 2 along M (each MT m16 tiles) x 2 along N (each 32 columns)
constexpr int kThreads = 128;

template <int MT, int MODE>
__global__ void __launch_bounds__(kThreads, 2) unet_conv_kernel(const Params p) {
  constexpr int BM = MT * 32, kS = stages_in_flight<MODE>();
  constexpr int kA = a_floats<MT, MODE>();
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                          // kS x kA
  float* b_s = a_s + kS * kA;                 // nb x (BN x ldb, or kBK x kLdKN)
  RowInfo* rows = reinterpret_cast<RowInfo*>(b_s + p.nb * (MODE == kDeconv ? kBK * kLdKN : kBN * p.ldb));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  static_assert(BM % (kThreads / 4) == 0 && (kBK * kBN / 4) % kThreads == 0, "tile and threads");
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int bsize = MODE == kDeconv ? kBK * kLdKN : kBN * p.ldb;
  // kHalo: the block's patch
  const int tx = MODE == kHalo ? blockIdx.x % p.tiles_x : 0;
  const int ty = MODE == kHalo ? (blockIdx.x / p.tiles_x) % p.tiles_y : 0;
  const int img0 = MODE == kHalo ? blockIdx.x / (p.tiles_x * p.tiles_y) : 0;

  for (int r = tid; r < BM; r += kThreads) {
    int m = m0 + r, ok = m < p.M;
    if (MODE == kHalo) {
      const int oy = ty * (BM / kPatchW) + r / kPatchW, ox = tx * kPatchW + r % kPatchW;
      ok = oy < p.OH && ox < p.OW;
      m = (img0 * p.OH + oy) * p.OW + ox;
    }
    RowInfo ri{-1, 0, 0, -1};
    if (ok) {
      const int ox = m % p.OW, rest = m / p.OW, oy = rest % p.OH, img = rest / p.OH;
      ri.base = img * p.H * p.W;
      ri.iy0 = oy * p.stride - p.pad;
      ri.ix0 = ox * p.stride - p.pad;
      ri.out = m;
    }
    rows[r] = ri;
  }
  __syncthreads();

  const int cin = p.C1 + p.C2;
  const int kg = p.C1 * p.KH * p.KW;  // kGather: the flattened K
  const int taps = MODE == kHalo ? 1 : p.T;  // taps a pipeline stage
  const int q0 = blockIdx.z * p.cps;           // this split's first chunk
  const int stages = (min(p.chunks, q0 + p.cps) - q0) * taps;

  // the A rows this thread loads (kConv, kDeconv): the pixel of tap (0, 0) and
  // its coordinates, held in registers; a row beyond M lies far outside
  constexpr int kRowsA = BM * 4 / kThreads;
  int a_pix[kRowsA], a_iy[kRowsA], a_ix[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const RowInfo ri = rows[(tid >> 2) + (kThreads / 4) * i];
    a_iy[i] = ri.base >= 0 ? ri.iy0 : -(1 << 28);
    a_ix[i] = ri.ix0;
    a_pix[i] = ri.base + ri.iy0 * p.W + ri.ix0;
  }
  // the B pieces this thread loads (kConv, kHalo): a column n's 4*T pieces are
  // split between kThreads / kBN threads
  constexpr int kTpr = kThreads / kBN;
  const int b_row = tid / kTpr, b_part0 = tid % kTpr;

  auto load_stage = [&](int s) {
    const int qs = s / taps, q = q0 + qs, tap = s - qs * taps;
    float* a_dst = a_s + (s % kS) * kA;
    if (MODE == kGather) {
      const int kk = tid & 15, k = q * kBK + kk;
      const bool k_ok = k < kg;
      const int c = k_ok ? k / (p.KH * p.KW) : 0, r = k_ok ? k - c * p.KH * p.KW : 0;
      const int ky = r / p.KW, kx = r - ky * p.KW;
#pragma unroll 4
      for (int i = 0; i < BM * kBK / kThreads; ++i) {
        const int row = (tid >> 4) + (kThreads / 16) * i;
        const RowInfo ri = rows[row];
        const int iy = ri.iy0 + ky, ix = ri.ix0 + kx;
        const bool ok = k_ok && ri.base >= 0 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        const float* src = ok ? p.x + (static_cast<size_t>(ri.base) + iy * p.W + ix) * p.C1 + c : p.x;
        cp_async4(a_dst + row * kLdA + kk, src, ok);
      }
    } else {
      const int c0 = q * kBK;
      const bool second = c0 >= p.C1;
      const float* src0 = second ? p.x2 : p.x;
      const int cs = second ? p.C2 : p.C1, c = second ? c0 - p.C1 : c0;
      if (MODE == kHalo) {  // the patch's halo, 16 channels a pixel
        using HaloT = Halo<BM>;
        const int iy0 = ty * (BM / kPatchW) - 1, ix0 = tx * kPatchW - 1;
        const float* src_c = src0 + static_cast<size_t>(img0) * p.H * p.W * cs + c;
        for (int e = tid; e < HaloT::H * HaloT::W * 4; e += kThreads) {
          const int pix = e >> 2, part = e & 3, hy = pix / HaloT::W, hx = pix - hy * HaloT::W;
          const int iy = iy0 + hy, ix = ix0 + hx;
          const bool ok = static_cast<unsigned>(iy) < static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(ix) < static_cast<unsigned>(p.W);
          const float* src = ok ? src_c + static_cast<size_t>(iy * p.W + ix) * cs + part * 4 : src0;
          cp_async16(a_dst + pix * kLdA + part * 4, src, ok);
        }
      } else {
        const float* src_c = src0 + c + (tid & 3) * 4;
        const int ky = tap / p.KW, kx = tap - ky * p.KW, tap_off = ky * p.W + kx;
#pragma unroll
        for (int i = 0; i < kRowsA; ++i) {
          const int row = (tid >> 2) + (kThreads / 4) * i;
          const bool ok = static_cast<unsigned>(a_iy[i] + ky) < static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(a_ix[i] + kx) < static_cast<unsigned>(p.W);
          const float* src = ok ? src_c + static_cast<size_t>(a_pix[i] + tap_off) * cs : src0;
          cp_async16(a_dst + row * kLdA + (tid & 3) * 4, src, ok);
        }
      }
    }
    if (tap != 0) return;
    float* b_dst = b_s + (qs % p.nb) * bsize;
    if (MODE == kGather) {
      const int kk = tid & 15, k = q * kBK + kk;
#pragma unroll
      for (int i = 0; i < kBN * kBK / kThreads; ++i) {
        const int nr = (tid >> 4) + (kThreads / 16) * i, n = n0 + nr;
        const bool ok = k < kg && n < p.N;
        cp_async4(b_dst + nr * p.ldb + kk, ok ? p.w + static_cast<size_t>(n) * kg + k : p.w, ok);
      }
    } else if (MODE == kDeconv) {
      // rows of W (C1, N) row-major: 16 rows x 64 columns, 16 pieces a row
#pragma unroll
      for (int i = 0; i < (kBK * kBN / 4) / kThreads; ++i) {
        const int piece = tid + kThreads * i, kr = piece >> 4, col = (piece & 15) * 4;
        const bool ok = n0 + col < p.N;
        const float* src = ok ? p.w + static_cast<size_t>(q * kBK + kr) * p.N + n0 + col : p.w;
        cp_async16(b_dst + kr * kLdKN + col, src, ok);
      }
    } else {
      // each column n: W[n, c0:c0+16, :, :], 16*T contiguous floats
      const int n = n0 + b_row;
      const bool ok = n < p.N;
      const float* src = p.w + (static_cast<size_t>(ok ? n : 0) * cin + q * kBK) * p.T;
      float* dst = b_dst + b_row * p.ldb;
      for (int part = b_part0; part < 4 * p.T; part += kTpr) cp_async16(dst + part * 4, src + part * 4, ok);
    }
  };

  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // 16 channels of one tap: a_lane is this lane's ldmatrix row address for
  // m-tile 0 (m-tile i lies a_step floats further), b_lane its B word for
  // n-tile 0, k 0 (b_n floats to the next n-tile, b_k to the next k). The
  // products go, the cross terms first, into fresh sums, which are then added
  // to acc rounded to nearest: the tensor cores round their sums toward zero,
  // which over a long K would bias the result by ulps a step.
  auto multiply = [&](const float* a_lane, int a_step, const float* b_lane, int b_n, int b_k) {
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      unsigned ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldmatrix_x4(ah[i], a_lane + i * a_step + kk * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(__uint_as_float(ah[i][r]), ah[i][r], al[i][r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) split_tf32(b_lane[j * b_n + (kk * 8 + r * 4) * b_k], bh[j][r], bl[j][r]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kk == 0) {
            mma_tf32_zero(part[i][j], al[i], bh[j]);
          } else {
            mma_tf32(part[i][j], al[i], bh[j]);
          }
          mma_tf32(part[i][j], ah[i], bl[j]);
          mma_tf32(part[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  };

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < stages) load_stage(s);
    cp_async_commit();
  }

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (s + kS - 1 < stages) load_stage(s + kS - 1);
    cp_async_commit();

    const int qs = s / taps, tap = s - qs * taps;
    const float* a_stage = a_s + (s % kS) * kA;
    const float* b_stage = b_s + (qs % p.nb) * bsize;
    // the lane's ldmatrix row: row (lane & 7) of tile lane / 8 of the fragment
    const int frag_row = ((lane >> 3) & 1) * 8 + (lane & 7), frag_col = (lane >> 4) * 4;
    if (MODE == kDeconv) {
      multiply(a_stage + (wm * MT * 16 + frag_row) * kLdA + frag_col, 16 * kLdA,
               b_stage + t4 * kLdKN + wn * 32 + g, 8, kLdKN);
    } else if (MODE == kHalo) {
      // m-tile i is patch rows 2i and 2i + 1 (of 8 pixels) of the warp's 2*MT
      using HaloT = Halo<BM>;
      const float* a_lane = a_stage + ((wm * MT * 2 + (frag_row >> 3)) * HaloT::W + (frag_row & 7)) * kLdA + frag_col;
      const float* b_lane = b_stage + (wn * 32 + g) * p.ldb + t4 * p.T;
#pragma unroll 1
      for (int t = 0; t < p.T; ++t) {
        const int ky = t / 3, kx = t - ky * 3;
        multiply(a_lane + (ky * HaloT::W + kx) * kLdA, 2 * HaloT::W * kLdA, b_lane + t, 8 * p.ldb, p.T);
      }
    } else {
      multiply(a_stage + (wm * MT * 16 + frag_row) * kLdA + frag_col, 16 * kLdA,
               b_stage + (wn * 32 + g) * p.ldb + t4 * p.T + tap, 8 * p.ldb, p.T);
    }
  }
  cp_async_wait<0>();

  float* out_s = smem;  // the transposed conv's output tile, staged
  if (MODE == kDeconv) __syncthreads();  // every warp is done with the operands

  if (p.splits > 1) {  // this split's sums; unet_conv_finish adds the splits in order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int vr = 0; vr < 2; ++vr) {
          const int pix = rows[wm * MT * 16 + i * 16 + g + vr * 8].out;
          if (pix >= 0 && n < p.N)
            *reinterpret_cast<float2*>(p.partial + (static_cast<size_t>(blockIdx.z) * p.M + pix) * p.N + n) =
                make_float2(acc[i][j][vr * 2], acc[i][j][vr * 2 + 1]);
        }
    }
    return;
  }

  // epilogue: bias, BN, residual, ReLU, NHWC store; a lane's two adjacent
  // columns go as one 8-byte access where they are adjacent in memory
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * t4;
    if (n >= p.N) continue;
    float add[2], mul[2], beta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = MODE == kDeconv ? (n + h) >> 2 : min(n + h, p.N - 1);
      const float b = p.bias ? p.bias[co] : 0.f;
      if (p.bn_w) {  // (v + b - mean) * mul + beta
        add[h] = b - p.bn_mean[co];
        mul[h] = rsqrtf(p.bn_var[co] + p.eps) * p.bn_w[co];
        beta[h] = p.bn_b[co];
      } else {
        add[h] = b, mul[h] = 1.f, beta[h] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int vr = 0; vr < 2; ++vr) {
        const int row = wm * MT * 16 + i * 16 + g + vr * 8, pix = rows[row].out;
        if (pix < 0) continue;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) v[h] = (acc[i][j][vr * 2 + h] + add[h]) * mul[h] + beta[h];
        if (MODE == kDeconv) {  // to the staging tile: [row][phase][16 channels]
          const int nl = n - n0;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out_s[row * kLdOut + ((nl + h) & 3) * 16 + ((nl + h) >> 2)] = p.relu ? fmaxf(v[h], 0.f) : v[h];
          continue;
        }
        const size_t o = static_cast<size_t>(pix) * p.cout + n;
        const bool pair = n + 1 < p.N && (p.cout & 1) == 0;
        if (pair) {
          if (p.res) {
            const float2 r = *reinterpret_cast<const float2*>(p.res + o);
            v[0] += r.x, v[1] += r.y;
          }
          if (p.relu) v[0] = fmaxf(v[0], 0.f), v[1] = fmaxf(v[1], 0.f);
          *reinterpret_cast<float2*>(p.out + o) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (n + h >= p.N) break;
            float u = v[h] + (p.res ? p.res[o + h] : 0.f);
            p.out[o + h] = p.relu ? fmaxf(u, 0.f) : u;
          }
        }
      }
  }
  if (MODE == kDeconv) {
    // each input pixel's 2 x 2 output pixels, 16 channels (64 bytes) each
    __syncthreads();
    const int co0 = n0 >> 2;
    for (int piece = tid; piece < BM * 16; piece += kThreads) {
      const int row = piece >> 4, phase = (piece >> 2) & 3, quad = piece & 3, m = m0 + row;
      if (m >= p.M || co0 + quad * 4 >= p.cout) continue;
      const int x = m % p.OW, rest = m / p.OW, y = rest % p.OH, img = rest / p.OH;
      const size_t o = ((static_cast<size_t>(img) * 2 * p.OH + 2 * y + (phase >> 1)) * 2 * p.OW + 2 * x + (phase & 1)) *
                           p.cout + co0 + quad * 4;
      *reinterpret_cast<float4*>(p.out + o) = *reinterpret_cast<const float4*>(out_s + row * kLdOut + phase * 16 + quad * 4);
    }
  }
}

template <int MT, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = MT * 32;
  const size_t bytes = (stages_in_flight<MODE>() * a_floats<MT, MODE>() +
                        p.nb * (MODE == kDeconv ? kBK * kLdKN : kBN * p.ldb)) * sizeof(float) +
                       BM * sizeof(RowInfo);
  static size_t opted = 0;  // the dynamic shared memory this instantiation was allowed
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(unet_conv_kernel<MT, MODE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted = bytes;
  }
  const int blocks_m = MODE == kHalo ? p.B * p.tiles_x * p.tiles_y : (p.M + BM - 1) / BM;
  const dim3 grid(blocks_m, (p.N + kBN - 1) / kBN, p.splits);
  unet_conv_kernel<MT, MODE><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The splits' sums added in split order, then the epilogue: 4 columns a thread.
__global__ void unet_conv_finish(const Params p) {
  const long quad = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (quad * 4 >= static_cast<long>(p.M) * p.N) return;
  const int n = static_cast<int>(quad * 4 % p.N);
  const size_t o = quad * 4;
  float4 v = *reinterpret_cast<const float4*>(p.partial + o);
  for (int z = 1; z < p.splits; ++z) {
    const float4 u = *reinterpret_cast<const float4*>(p.partial + static_cast<size_t>(z) * p.M * p.N + o);
    v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
  }
  float r[4] = {v.x, v.y, v.z, v.w};
  const float4 res = p.res ? *reinterpret_cast<const float4*>(p.res + o) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float rs[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int co = n + h;
    float u = r[h] + (p.bias ? p.bias[co] : 0.f);
    if (p.bn_w) u = (u - p.bn_mean[co]) * (rsqrtf(p.bn_var[co] + p.eps) * p.bn_w[co]) + p.bn_b[co];
    u += rs[h];
    r[h] = p.relu ? fmaxf(u, 0.f) : u;
  }
  *reinterpret_cast<float4*>(p.out + o) = make_float4(r[0], r[1], r[2], r[3]);
}

template <int MODE>
cudaError_t dispatch(const Params& p, int rows, cudaStream_t stream) {
  return rows == 128 ? launch<4, MODE>(p, stream) : launch<2, MODE>(p, stream);
}

}  // namespace

// x: (B, H, W, C1) and x2: (B, H, W, C2) or NULL, NHWC f32. Conv: w (cout,
// C1+C2, KH, KW), out (B, OH, OW, cout). Transposed (KH = KW = stride = 2, pad
// 0): w (C1, cout, 2, 2), out (B, 2H, 2W, cout), OH = H and OW = W. bias, the
// four BN vectors (all or none) and res ((B, OH, OW, cout), conv only) may be
// NULL. splits > 1 (a conv's K cut into that many blocks along z, added by a
// second launch) needs partial, (splits, B*OH*OW, cout) floats. rows (64 or
// 128) are a block's output rows, except in the halo mode (always 128).
// Returns a cudaError_t.
extern "C" int mvkp_unet_conv(const float* x, const float* x2, const float* w, const float* bias,
                              const float* bn_w, const float* bn_b, const float* bn_mean, const float* bn_var,
                              const float* res, float* out, int b, int h, int wd, int c1, int c2, int oh, int ow,
                              int cout, int kh, int kw, int stride, int pad, int transposed, int relu, float eps,
                              float* partial, int splits, int rows, cudaStream_t stream) {
  Params p{};
  splits = splits < 1 ? 1 : splits;
  p.partial = partial; p.splits = splits;
  p.x = x; p.x2 = x2; p.w = w; p.bias = bias;
  p.bn_w = bn_w; p.bn_b = bn_b; p.bn_mean = bn_mean; p.bn_var = bn_var;
  p.res = res; p.out = out;
  p.H = h; p.W = wd; p.C1 = c1; p.C2 = x2 ? c2 : 0;
  p.KH = kh; p.KW = kw; p.stride = stride; p.pad = pad;
  p.relu = relu; p.eps = eps; p.cout = cout;
  if (b <= 0 || oh <= 0 || ow <= 0) return 0;
  if (rows != 64 && rows != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cout <= 0 || c1 <= 0 || (bn_w == nullptr) != (bn_var == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (transposed) {
    if (splits > 1 || kh != 2 || kw != 2 || stride != 2 || pad != 0 || x2 || res || c1 % kBK || cout % 16 || oh != h || ow != wd)
      return static_cast<int>(cudaErrorInvalidValue);
    p.KH = p.KW = p.stride = 1;  // the A tile is the input pixel itself
    p.OH = h; p.OW = wd; p.M = b * h * wd; p.N = 4 * cout;
    p.T = 1; p.chunks = p.cps = c1 / kBK; p.ldb = kLdKN; p.nb = kStages;
    return static_cast<int>(dispatch<kDeconv>(p, rows, stream));
  }
  p.OH = oh; p.OW = ow; p.M = b * oh * ow; p.N = cout;
  if (c1 % kBK == 0 && p.C2 % kBK == 0) {
    p.T = kh * kw; p.chunks = (c1 + p.C2) / kBK;
    if (splits > 1) {  // (conv only) the K chunks cut into splits, summed by unet_conv_finish
      if (!partial || cout % 4 || splits > p.chunks) return static_cast<int>(cudaErrorInvalidValue);
      p.cps = (p.chunks + splits - 1) / splits;
      p.splits = (p.chunks + p.cps - 1) / p.cps;
    } else {
      p.cps = p.chunks;
    }
    p.ldb = kBK * p.T + 4;
    p.nb = p.T >= kStages - 1 ? 2 : kStages;
    // a 3x3 stride-1 conv whose rows are whole patches of 8 pixels: the halo
    if (kh == 3 && kw == 3 && stride == 1 && pad == 1 && ow % kPatchW == 0 && splits == 1) {
      p.B = b; p.tiles_x = (ow + kPatchW - 1) / kPatchW; p.tiles_y = (oh + 15) / 16; p.nb = 2;
      return static_cast<int>(launch<4, kHalo>(p, stream));
    }
    cudaError_t err = dispatch<kConv>(p, rows, stream);
    if (err == cudaSuccess && p.splits > 1) {
      const long quads = static_cast<long>(p.M) * p.N / 4;
      unet_conv_finish<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(p);
      err = cudaGetLastError();
    }
    return static_cast<int>(err);
  }
  if (x2 || splits > 1) return static_cast<int>(cudaErrorInvalidValue);
  p.T = 1; p.chunks = p.cps = (c1 * kh * kw + kBK - 1) / kBK; p.ldb = kBK + 4; p.nb = kStages;
  return static_cast<int>(dispatch<kGather>(p, rows, stream));
}
