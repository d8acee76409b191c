// P1: farthest point sampling, one thread-block cluster a cloud.
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
// argmaxes over the whole cloud sets the time: the kernel is built to make
// one step's chain short and to spread a step's point work over several SMs.
//
// Design: a cloud is one thread-block cluster of C CTAs (C in 1, 2, 4, 8),
// launched with cudaLaunchKernelEx and a cluster-dimension attribute.
//  - Ownership by index: CTA rank r owns the contiguous range [r*span,
//    (r+1)*span) of the cloud, span = ceil(N / C); thread t of a CTA owns
//    the K <= 8 points from r*span + t*K on (within the range), their
//    coordinates and running minima in registers. So lane order within a
//    warp, warp order within a CTA and rank order are all index order, and
//    slot q = rank * W + warp of a step's W warp winners a CTA is too.
//  - The key: a point's running minimum as a signed 32-bit integer. d^2 >= 0
//    orders as its bits do; a masked or missing point keeps the minimum -1,
//    a negative key, below every valid one. The larger key wins; among equal
//    keys the lower index (torch.argmax's rule).
//  - One exchange a step: each warp takes its winner with __reduce_max_sync
//    on the key and the lowest lane of __ballot_sync (a thread keeps the
//    first of its points with its best key, so that is the lowest index).
//    For C > 1 the winning lane writes (key, x, y, z) into slot q of every
//    CTA of the cluster with st.async through distributed shared memory,
//    each store completing bytes on that CTA's transaction mbarrier; the
//    mbarrier is the step's one barrier: it completes once all C x W
//    winners have landed, so no CTA goes on before every warp of the cluster
//    has delivered. (On an H100 a barrier.cluster of every thread, then
//    loads of the remote slots, measured slower a step at every cluster
//    size.) For C = 1 the slots are written in place and the barrier is
//    __syncthreads. Then every warp reduces the C x W slots from its own
//    shared memory, a contiguous run of them a lane, the same way: every
//    thread so holds the next centroid's coordinates with no second barrier
//    and no load from device memory. The warp whose slot won writes
//    out[step] (its winning lane holds the index).
//  - Slots and mbarriers are double-buffered by step parity. Slot q of
//    parity p is rewritten two steps later, by a warp that has passed the
//    next step's barrier, which every warp of the cluster reaches only after
//    reading this step's slots; thread 0 re-arms the mbarrier (one arrival
//    with the step's bytes) after its wait; a last cluster barrier keeps a
//    CTA from exiting while a store may still be on its way.
//  - The plan (C, threads, K) is chosen by N alone in Python (fps.plan) and
//    passed in: one CTA up to fps.CTA_POINTS points (K = 1, 2, 4 or 8, the
//    fewest that keep it at 128 threads or fewer), else C = 2, 4 or 8 with
//    K = 8. Above 8 CTAs x 1024 threads x 8 points (65,536) K = 0: the
//    minima live in a scratch array, a warp owns a contiguous run of its
//    CTA's range and its lanes stride through it (coalesced), so the warp
//    argmax takes the least index among the lanes with the largest key. Only those (C, K) are built (fps.py
//    INSTANCES lists them); mvkp_fps refuses any other.
// A cluster that cannot be placed (cudaOccupancyMaxActiveClusters gives 0)
// or a refused launch returns its error; nothing falls back to another plan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxClusters = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1.0f;  // a masked or missing point's running minimum: a negative key

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory word in the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into a (remote) CTA's shared memory, completing them on its mbarrier.
__device__ __forceinline__ void send(uint32_t dst, uint32_t bar, float4 v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
                  "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// The one arrival of the mbarrier's next phase, which then waits for `bytes`.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// kCluster: C > 1, the winners exchanged through distributed shared memory;
// else C = 1 and __syncthreads.
template <int K, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
               int32_t* __restrict__ out, float* __restrict__ scratch, int n, int s, int span) {
  __shared__ float4 slots[2][kMaxClusters * kMaxWarps];  // (key, x, y, z) a warp winner
  __shared__ alignas(8) uint64_t full[2];                 // a step's winners have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = kCluster ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const int b = blockIdx.x / nranks;
  const float* p = points + static_cast<size_t>(b) * n * 3;
  const uint8_t* m = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  int32_t* o = out + static_cast<size_t>(b) * s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int lo = rank * span, hi = min(lo + span, n);
  const int mine = rank * nwarps + warp;  // this warp's slot
  // This lane's slots in the cluster-wide reduction: a contiguous run, so
  // lane order stays index order.
  const int nslots = nranks * nwarps, per = (nslots + 31) / 32;
  const int q0 = lane * per, q1 = min(q0 + per, nslots);
  const uint32_t bytes = static_cast<uint32_t>(nslots * sizeof(float4));
  if constexpr (kCluster) {
    if (tid == 0) {
      bar_init(smem_u32(&full[0]));
      bar_init(smem_u32(&full[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (s > 1) bar_expect(smem_u32(&full[1]), bytes);  // step 1
      if (s > 2) bar_expect(smem_u32(&full[0]), bytes);  // step 2
    }
    cluster.sync();  // every CTA's mbarriers are ready before any store
  }

  float x[K > 0 ? K : 1], y[K > 0 ? K : 1], z[K > 0 ? K : 1], dmin[K > 0 ? K : 1];
  const int first = lo + tid * K;
  // K == 0: this warp's run of the CTA's range, its lanes striding by 32
  const int wspan = (span + nwarps - 1) / nwarps;
  const int wlo = min(lo + warp * wspan, hi), whi = min(wlo + wspan, hi);
  float* dmin_g = K > 0 ? nullptr : scratch + static_cast<size_t>(b) * n;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k;
      x[k] = y[k] = z[k] = 0.f;
      dmin[k] = kMasked;
      if (i < hi) {
        x[k] = p[3 * i];
        y[k] = p[3 * i + 1];
        z[k] = p[3 * i + 2];
        if (!m || m[i]) dmin[k] = __int_as_float(0x7f800000);
      }
    }
  } else {
    for (int i = wlo + lane; i < whi; i += 32) dmin_g[i] = (!m || m[i]) ? __int_as_float(0x7f800000) : kMasked;
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  float cx = p[0], cy = p[1], cz = p[2];

  for (int step = 1; step < s; ++step) {
    // 1. This thread's best point: the first of the largest key.
    int bkey = INT_MIN, bidx = 0;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if constexpr (K > 0) {
      int bk = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float d = fminf(dmin[k], sq_dist(x[k], y[k], z[k], cx, cy, cz));
        dmin[k] = d;
        if (__float_as_int(d) > bkey) {
          bkey = __float_as_int(d);
          bk = k;
          bx = x[k];
          by = y[k];
          bz = z[k];
        }
      }
      bidx = first + bk;
    } else {
      for (int i = wlo + lane; i < whi; i += 32) {
        const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
        const float d = fminf(dmin_g[i], sq_dist(px, py, pz, cx, cy, cz));
        dmin_g[i] = d;
        if (__float_as_int(d) > bkey) {
          bkey = __float_as_int(d);
          bidx = i;
          bx = px;
          by = py;
          bz = pz;
        }
      }
    }
    // 2. The warp's winner: the lowest lane of the largest key.
    const int wkey = __reduce_max_sync(kFull, bkey);
    unsigned ties = __ballot_sync(kFull, bkey == wkey);
    if constexpr (K == 0) {  // lanes stride: the least index among the ties
      const unsigned widx = __reduce_min_sync(kFull, bkey == wkey ? static_cast<unsigned>(bidx) : UINT_MAX);
      ties = __ballot_sync(kFull, bkey == wkey && static_cast<unsigned>(bidx) == widx);
    }
    const int wsrc = __ffs(ties) - 1;
    const int par = step & 1;
    const float4 win = make_float4(__int_as_float(bkey), bx, by, bz);
    // 3. The exchange and the step's one barrier.
    if constexpr (kCluster) {
      const uint32_t dst = smem_u32(&slots[par][mine]), bar = smem_u32(&full[par]);
      if (lane == wsrc) {
        for (int r = 0; r < nranks; ++r) send(map_rank(dst, r), map_rank(bar, r), win);
      }
      bar_wait(bar, ((step - 1) >> 1) & 1);
      if (tid == 0 && step + 2 < s) bar_expect(bar, bytes);  // step + 2 uses it next
    } else {
      if (lane == wsrc) slots[par][mine] = win;
      __syncthreads();
    }
    // 4. Every warp reduces all C x W slots.
    float4 a = make_float4(__int_as_float(INT_MIN), 0.f, 0.f, 0.f);
    int aq = q0;
    for (int q = q0; q < q1; ++q) {
      const float4 r = slots[par][q];
      if (__float_as_int(r.x) > __float_as_int(a.x)) {
        a = r;
        aq = q;
      }
    }
    const int ckey = __reduce_max_sync(kFull, __float_as_int(a.x));
    const int src = __ffs(__ballot_sync(kFull, q0 < q1 && __float_as_int(a.x) == ckey)) - 1;
    cx = __shfl_sync(kFull, a.y, src);
    cy = __shfl_sync(kFull, a.z, src);
    cz = __shfl_sync(kFull, a.w, src);
    if (__shfl_sync(kFull, aq, src) == mine && lane == wsrc) o[step] = bidx;
  }
  if constexpr (kCluster) cluster.sync();  // 5. no CTA leaves while a store may be on its way
}

template <int K, bool kCluster>
cudaError_t launch(const float* points, const uint8_t* mask, int32_t* out, float* scratch, int b, int n, int s,
                   int clusters, int threads, cudaStream_t stream) {
  // Whether a cluster of this shape fits on the card, asked once a shape.
  static int fits[kMaxClusters + 1][kMaxWarps + 1];  // 0 unknown, 1 yes, 2 no
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(b * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int& fit = fits[clusters][threads / 32];
  if (fit == 0) {
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&active, fps_kernel<K, kCluster>, &cfg);
    if (err != cudaSuccess) return err;
    fit = active > 0 ? 1 : 2;
  }
  if (fit != 1) return cudaErrorLaunchOutOfResources;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fps_kernel<K, kCluster>, points, mask, out,
                                             K > 0 ? nullptr : scratch, n, s, (n + clusters - 1) / clusters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// clusters: CTAs a cloud, each owning span = ceil(n / clusters) points;
// threads: a CTA's, a multiple of 32 up to 1024; k: points a thread in
// registers (threads * k >= span), or 0 for the scratch array (then scratch
// holds B * N floats). (clusters, k) is one of fps.py's INSTANCES, the plans
// of ops/kernels/fps.py's plan(n): 1 with k = 1, 2, 4 or 8; 2, 4 or 8 with
// k = 8; 8 with k = 0.
extern "C" int mvkp_fps(const float* points, const uint8_t* mask, int32_t* out, float* scratch, int b, int n,
                        int s, int clusters, int threads, int k, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  const bool shape_ok = n > 0 && threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
                        (k == 0 ? scratch != nullptr : threads * k >= (n + clusters - 1) / clusters);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (clusters == 1) {
    switch (k) {
      case 1: err = launch<1, false>(points, mask, out, scratch, b, n, s, 1, threads, stream); break;
      case 2: err = launch<2, false>(points, mask, out, scratch, b, n, s, 1, threads, stream); break;
      case 4: err = launch<4, false>(points, mask, out, scratch, b, n, s, 1, threads, stream); break;
      case 8: err = launch<8, false>(points, mask, out, scratch, b, n, s, 1, threads, stream); break;
      default: break;
    }
  } else if ((clusters == 2 || clusters == 4 || clusters == 8) && k == 8) {
    err = launch<8, true>(points, mask, out, scratch, b, n, s, clusters, threads, stream);
  } else if (clusters == 8 && k == 0) {
    err = launch<0, true>(points, mask, out, scratch, b, n, s, clusters, threads, stream);
  }
  return static_cast<int>(err);
}
