// Segment sum of gather cotangent rows by target row: the VJP of group_points.
//
// Replaces: mvkpconv_tpu/ops/pallas/segsum.py, banded_window_segsum (kernel
// body _kernel, driven by mvkpconv_tpu/ops/gather.py:_transpose_banded). For
// rows (B*Nq*K, C) and their targets index (B, Nq, K) in [0, Ns),
//   out[b, t, :] = sum of rows[(b, q, k), :] over index[b, q, k] == t,
// accumulated in f32 from f32 or bf16 rows. With round_bf16, f32 rows are
// rounded to bf16 in registers (round to nearest even, __float2bfloat16_rn:
// what Tensor.to(torch.bfloat16) gives, overflow to inf included) before
// they are summed, so the gather VJP's banded_bf16 mode needs no cast pass
// of its own. The kernels write every element of out, zeros included: the
// caller allocates it uninitialised.
//
// What bounds it on the H100: the rows are read once (at the level-0
// resnetb site 1.97M x 32 x 4 B = 252 MB in f32, 126 MB in bf16: 0.075 and
// 0.038 ms at 3.35 TB/s) and the output written once (8.4 MB). A kernel that
// adds each row to the output by its own vector atomic sends C/4
// reductions to L2 a row (15.7M at that site), and those, not the reads, set
// its time: the rows of one target come from about 30 queries spread over
// the grid.
//
// Design: invert the index first (a plan, which depends on the index alone
// and so serves every gather VJP that shares it: the caller builds it once
// per index tensor and passes it in), then sum by target:
//   1. plan (mvkp_segsum_plan): the rows' numbers grouped by target in row
//      order, by a stable least-significant-digit radix sort of (target,
//      row) on the target's bits, kDigit bits or fewer a pass (two passes at
//      the bench's level 0): per pass a digit histogram per tile of kTile rows
//      (segsum_hist_kernel, which on the first pass also counts the rows a
//      target: one atomic a warp and target, the lanes of a warp with equal
//      targets, such as the shadow row's, merged first by __match_any_sync),
//      its exclusive scan (segsum_scan_kernel, a block a chunk of entries,
//      each block adding up the entries before its chunk itself, so the
//      blocks need nothing from each other), digit-major, and a
//      scatter (segsum_scatter_kernel) in which each warp ranks its rows in
//      row order (__match_any_sync, counts a warp in shared memory) and the
//      warps follow each other in order; then the counts' scan into CSR
//      offsets, which also lists the pieces of long targets: a target with
//      more than kLong rows (the shadow row, which every short neighbor list
//      and padded query points at) is cut into pieces of kLong rows. No step
//      depends on the order in which atomics land, so the plan, and with it
//      the sum, is the same bits from run to run;
//   2. sum (segsum_sum_kernel): a warp a target or a piece and a group of at
//      most kGroup V-element pieces of its row (V = 8 bf16 or 4 f32 values,
//      16 bytes, where C and the rows' alignment allow; fewer otherwise); a
//      wider row is split into groups, each a warp of its own, so that the
//      few wide targets of the deep levels still fill the card. The lanes
//      form R row slots of P' lanes, P' the group's pieces rounded up to a
//      power of two. A slot reads every R-th row of the list, four at a time,
//      and adds in f32 registers; the slots meet by __shfl_xor_sync and slot
//      0 stores the group's part of the target's row, one vector store a
//      piece: no atomics on the output. A long target's pieces store partial
//      rows into the call's scratch; the last (piece, group) to finish (a
//      counter a target in the same scratch, zeroed by the call) adds the
//      partials in piece order and stores the row. The plan is read only, so
//      any number of sums may use it at once.
//
// Compiled with -DMVKP_CYCLES the sum kernel also counts, in segsum_counts:
// rows summed, targets stored whole, pieces of long targets, and the cycles
// its warps spend waiting for list entries, in row reads and sums, and in
// the slot reduction and stores (clock64 by lane 0, summed over the items),
// read by mvkp_segsum_counts. The default build has none of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifdef MVKP_CYCLES
// [0] rows summed, [1] targets stored whole, [2] pieces of long targets,
// [3] cycles in list reads, [4] in row reads and sums, [5] in the slot
// reduction and the stores
__device__ unsigned long long segsum_counts[6];
#define SEG_NOW() clock64()
#define SEG_ADD(i, v) atomicAdd(&segsum_counts[i], static_cast<unsigned long long>(v))
#else
#define SEG_NOW() 0ll
#define SEG_ADD(i, v) (void)(v)
#endif

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;  // entries a scan thread takes
constexpr int kChunk = kScanThreads * kScanPer;  // entries a scan block takes
constexpr int kLong = 256;   // most rows one warp sums
constexpr int kUnroll = 4;   // rows a slot asks for at once
constexpr int kGroup = 8;    // most pieces of a row one item sums
constexpr int kDigit = 9;    // most bits a sort pass takes
constexpr int kBuckets = 1 << kDigit;
constexpr int kSortPer = 12;  // rows a sort thread takes
constexpr int kTile = kThreads * kSortPer;  // rows a sort block takes
constexpr int kSortWarps = kThreads / 32;

// The plan of an index, int32, for m = b * ns targets and n = b * rows_per_b
// rows: counts[m] (rows a target), start[m + 1] (CSR offsets, from a 16-byte
// boundary), n_pieces (pieces of long targets listed), order[n] (row numbers
// grouped by target, in row order within a target; rows whose target is out
// of range last), pieces[P] as int4 {target, piece, first piece's number,
// pieces of the target}. A long target of v > kLong rows has ceil(v / kLong)
// pieces, so P = 2 (n / kLong) + 2 holds them all.
struct Layout {
  long long start, n_pieces, order, pieces, total, max_pieces;
};

__host__ __device__ inline Layout layout(long long m, long long n) {
  Layout l;
  l.max_pieces = 2 * (n / kLong) + 2;
  l.start = (m + 3) & ~3ll;  // counts at 0, both 16-byte aligned
  l.n_pieces = l.start + m + 1;
  l.order = l.n_pieces + 1;
  l.pieces = (l.order + n + 3) & ~3ll;  // 16-byte aligned
  l.total = l.pieces + 4 * l.max_pieces;
  return l;
}

// The scratch a plan's sort takes, int32: two (key, row) buffers of n, and a
// digit histogram of kBuckets x tiles with its scan (one more entry each for
// the total), all from 16-byte boundaries.
struct SortLayout {
  long long keys0, rows0, keys1, rows1, hist, offsets, total, tiles;
};

__host__ inline SortLayout sort_layout(long long n) {
  SortLayout s;
  const long long n4 = (n + 3) & ~3ll;
  s.tiles = (n + kTile - 1) / kTile;
  const long long h4 = (kBuckets * s.tiles + 1 + 3) & ~3ll;
  s.keys0 = 0;
  s.rows0 = n4;
  s.keys1 = 2 * n4;
  s.rows1 = 3 * n4;
  s.hist = 4 * n4;
  s.offsets = s.hist + h4;
  s.total = s.offsets + h4;
  return s;
}

// The batch element i / rows_per_b of a thread's rows, which it takes in
// increasing order: no division a row.
struct BatchOf {
  unsigned rows_per_b, b, next;
  __device__ BatchOf(unsigned i0, unsigned rpb) : rows_per_b(rpb), b(i0 / rpb), next((i0 / rpb + 1) * rpb) {}
  __device__ __forceinline__ unsigned operator()(unsigned i) {
    while (i >= next) {
      ++b;
      next += rows_per_b;
    }
    return b;
  }
};

// The flat target b * ns + t of row i, or m = b * ns where t is out of range
// (it cannot come from a forward gather; such rows are sorted last and never
// summed).
__device__ __forceinline__ int key_of(const int* index, unsigned i, BatchOf& batch, int ns, int m) {
  const int t = __ldg(index + i);
  return static_cast<unsigned>(t) < static_cast<unsigned>(ns) ? static_cast<int>(batch(i)) * ns + t : m;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int pieces_of(int v) { return v > kLong ? (v + kLong - 1) / kLong : 0; }

// A block a chunk of kChunk entries of in[len] (16-byte aligned): out[j] =
// the sum of in[0, j), out[len] = the sum of all. With PIECES, in holds the
// rows of each target and the pieces of long targets are listed into pieces,
// their number into *n_pieces. Each block first adds up every chunk before
// its own (16-byte loads, which stay in L2), so the blocks need nothing from
// each other; the last one writes the totals.
template <bool PIECES>
__global__ void __launch_bounds__(kScanThreads)
segsum_scan_kernel(const int* __restrict__ in, int* __restrict__ out, int len, int4* __restrict__ pieces,
                   int* __restrict__ n_pieces) {
  __shared__ int tile[kChunk];
  __shared__ int warp_rows[kScanThreads / 32], warp_pieces[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kChunk;
  for (int j = tid; j < kChunk; j += kScanThreads) tile[j] = t0 + j < len ? in[t0 + j] : 0;
  // the chunks before this one
  int before_rows = 0, before_pieces = 0;
  {
    const int4* c4 = reinterpret_cast<const int4*>(in);
    for (int q = tid; q < t0 / 4; q += kScanThreads) {
      const int4 v = __ldcg(c4 + q);
      before_rows += v.x + v.y + v.z + v.w;
      if constexpr (PIECES) before_pieces += pieces_of(v.x) + pieces_of(v.y) + pieces_of(v.z) + pieces_of(v.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      before_rows += __shfl_xor_sync(0xffffffffu, before_rows, off);
      before_pieces += __shfl_xor_sync(0xffffffffu, before_pieces, off);
    }
    if (lane == 0) {
      warp_rows[warp] = before_rows;
      warp_pieces[warp] = before_pieces;
    }
    __syncthreads();
    before_rows = before_pieces = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      before_rows += warp_rows[w];
      before_pieces += warp_pieces[w];
    }
    __syncthreads();
  }
  int v[kScanPer], rows = 0, np = 0;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    v[j] = tile[tid * kScanPer + j];
    rows += v[j];
    if constexpr (PIECES) np += pieces_of(v[j]);
  }
  int inc_rows = rows, inc_pieces = np;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, inc_rows, off);
    const int e = __shfl_up_sync(0xffffffffu, inc_pieces, off);
    if (lane >= off) {
      inc_rows += a;
      inc_pieces += e;
    }
  }
  if (lane == 31) {
    warp_rows[warp] = inc_rows;
    warp_pieces[warp] = inc_pieces;
  }
  __syncthreads();
  if (warp == 0) {
    int a = warp_rows[lane], e = warp_pieces[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int pa = __shfl_up_sync(0xffffffffu, a, off);
      const int pe = __shfl_up_sync(0xffffffffu, e, off);
      if (lane >= off) {
        a += pa;
        e += pe;
      }
    }
    warp_rows[lane] = a;  // inclusive over warps
    warp_pieces[lane] = e;
  }
  __syncthreads();
  int run = before_rows + inc_rows - rows + (warp > 0 ? warp_rows[warp - 1] : 0);
  int piece = before_pieces + inc_pieces - np + (warp > 0 ? warp_pieces[warp - 1] : 0);
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    tile[tid * kScanPer + j] = run;
    if constexpr (PIECES) {
      const int t = t0 + tid * kScanPer + j;
      const int pt = pieces_of(v[j]);
      for (int p = 0; p < pt; ++p) pieces[piece + p] = make_int4(t, p, piece, pt);
      piece += pt;
    }
    run += v[j];
  }
  __syncthreads();
  for (int j = tid; j < kChunk; j += kScanThreads) {
    if (t0 + j < len) out[t0 + j] = tile[j];
  }
  if (t0 + kChunk >= len && tid == 0) {
    out[len] = before_rows + warp_rows[kScanThreads / 32 - 1];
    if constexpr (PIECES) *n_pieces = before_pieces + warp_pieces[kScanThreads / 32 - 1];
  }
}

// The key of entry i of a sort pass: from the index on the first pass, from
// the previous pass's keys after.
template <bool FIRST>
__device__ __forceinline__ int sort_key(const int* src, unsigned i, BatchOf& batch, int ns, int m) {
  if constexpr (FIRST) return key_of(src, i, batch, ns, m);
  return __ldg(src + i);
}

// The digit (key >> shift) & (buckets - 1) of every key of a tile of kTile,
// counted: hist[digit * tiles + tile] (digit-major, so that its exclusive
// scan gives each (digit, tile) its first place, tiles of a digit in order).
// The first pass also adds the rows of each target in range to counts.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
segsum_hist_kernel(const int* __restrict__ src, int* __restrict__ hist, int* __restrict__ counts, unsigned n,
                   unsigned rows_per_b, int ns, int m, int shift, int buckets, int tiles) {
  __shared__ int h[kBuckets];
  for (int d = threadIdx.x; d < buckets; d += kThreads) h[d] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  const unsigned t0 = blockIdx.x * static_cast<unsigned>(kTile);
  BatchOf batch(t0 + threadIdx.x, rows_per_b);
#pragma unroll 4
  for (int r = 0; r < kSortPer; ++r) {
    const unsigned i = t0 + r * kThreads + threadIdx.x;
    const int key = i < n ? sort_key<FIRST>(src, i, batch, ns, m) : -1;
    const int d = key >= 0 ? (key >> shift) & (buckets - 1) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && static_cast<int>(lane) == __ffs(same) - 1) atomicAdd(h + d, __popc(same));
    if constexpr (FIRST) {
      const unsigned same_key = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && key < m && static_cast<int>(lane) == __ffs(same_key) - 1)
        atomicAdd(counts + key, __popc(same_key));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < buckets; d += kThreads) hist[static_cast<size_t>(d) * tiles + blockIdx.x] = h[d];
}

// Exclusive scan of v[0, len) in place, len <= 2 * kThreads, by a block of
// kThreads; returns nothing until every thread has its part (it ends with a
// barrier).
__device__ void block_exclusive_scan(int* v, int len, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = 2 * tid < len ? v[2 * tid] : 0, b = 2 * tid + 1 < len ? v[2 * tid + 1] : 0;
  int inc = a + b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  const int ex = before + inc - a - b;
  if (2 * tid < len) v[2 * tid] = ex;
  if (2 * tid + 1 < len) v[2 * tid + 1] = ex + a;
  __syncthreads();
}

// One stable pass: every (key, row) of a tile to offsets[digit * tiles +
// tile] plus its rank among the tile's entries of its digit. Warp w takes
// the tile's w-th run of 32 * kSortPer entries, 32 at a time in order, and
// ranks them by its own counts (read by every lane, then raised by the
// leader of each digit's lanes); the warps' counts are then turned into
// each warp's first place per digit, warps in order. The tile is laid out
// in shared memory in its sorted order first and written from there, so
// that the entries of a digit leave as one run of consecutive addresses. On
// the last pass only the rows are written (the plan's order).
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads)
segsum_scatter_kernel(const int* __restrict__ src, const int* __restrict__ rows_in, int* __restrict__ keys_out,
                      int* __restrict__ rows_out, const int* __restrict__ offsets, unsigned n, unsigned rows_per_b,
                      int ns, int m, int shift, int buckets, int tiles) {
  __shared__ int cnt[kSortWarps][kBuckets];
  __shared__ int tile_start[kBuckets], base[kBuckets], warp_sums[kSortWarps];
  __shared__ int stage_key[kTile], stage_row[kTile];
  for (int j = threadIdx.x; j < kSortWarps * kBuckets; j += kThreads) (&cnt[0][0])[j] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned t0 = blockIdx.x * static_cast<unsigned>(kTile);
  const unsigned first = t0 + warp * (32u * kSortPer);
  BatchOf batch(first + lane, rows_per_b);
  int key[kSortPer], rank[kSortPer];
#pragma unroll
  for (int r = 0; r < kSortPer; ++r) {
    const unsigned i = first + r * 32 + lane;
    key[r] = i < n ? sort_key<FIRST>(src, i, batch, ns, m) : -1;
    const int d = key[r] >= 0 ? (key[r] >> shift) & (buckets - 1) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, d);
    rank[r] = d >= 0 ? cnt[warp][d] + __popc(same & lanemask_lt()) : 0;
    __syncwarp();
    if (d >= 0 && static_cast<int>(lane) == __ffs(same) - 1) cnt[warp][d] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first place within its digit's run in the tile, and the
  // tile's entries of each digit
  for (int d = threadIdx.x; d < buckets; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
    tile_start[d] = run;
  }
  __syncthreads();
  block_exclusive_scan(tile_start, buckets, warp_sums);
  for (int d = threadIdx.x; d < buckets; d += kThreads)
    base[d] = offsets[static_cast<size_t>(d) * tiles + blockIdx.x] - tile_start[d];
#pragma unroll
  for (int r = 0; r < kSortPer; ++r) {
    if (key[r] < 0) continue;
    const unsigned i = first + r * 32 + lane;
    const int d = (key[r] >> shift) & (buckets - 1);
    const int at = tile_start[d] + cnt[warp][d] + rank[r];
    stage_key[at] = key[r];
    stage_row[at] = FIRST ? static_cast<int>(i) : __ldg(rows_in + i);
  }
  __syncthreads();
  const int here = static_cast<int>(min(static_cast<unsigned>(kTile), n - t0));
  for (int j = threadIdx.x; j < here; j += kThreads) {
    const int k = stage_key[j];
    const int at = base[(k >> shift) & (buckets - 1)] + j;
    rows_out[at] = stage_row[j];
    if constexpr (!LAST) keys_out[at] = k;
  }
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void bf16x2(unsigned w, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  a = f.x;
  b = f.y;
}

// V consecutive elements of a row as f32 (rounded to bf16 first with ROUND),
// from a boundary of V elements: one 16-, 8-, 4- or 2-byte load.
template <typename T, int V, bool ROUND>
__device__ __forceinline__ void load_piece(const T* p, float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (V == 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = x.x; v[1] = x.y;
    } else {
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    }
    if constexpr (ROUND) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = round_bf16(v[j]);
    }
  } else {
    if constexpr (V == 8) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      bf16x2(x.x, v[0], v[1]);
      bf16x2(x.y, v[2], v[3]);
      bf16x2(x.z, v[4], v[5]);
      bf16x2(x.w, v[6], v[7]);
    } else if constexpr (V == 4) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      bf16x2(x.x, v[0], v[1]);
      bf16x2(x.y, v[2], v[3]);
    } else if constexpr (V == 2) {
      bf16x2(__ldg(reinterpret_cast<const unsigned*>(p)), v[0], v[1]);
    } else {
      v[0] = __bfloat162float(p[0]);
    }
  }
}

// V floats to o, 4V-byte aligned (two 16-byte stores for V = 8).
template <int V>
__device__ __forceinline__ void store_piece(float* o, const float (&v)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(o + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  } else {
    *o = v[0];
  }
}

// A warp an item: a target or a piece of a long target, and a group of pp
// pieces of its row (pp = 8 or fewer lanes a row slot; a row of more pieces
// is split into groups, each an item of its own, so that a few wide targets
// still fill the card). Unit u < m is target u, skipped if it is long; unit
// m + e is pieces[e], a piece of a long target, whose partial row goes to
// partials[(first piece + piece) * c]; the last of the target's pieces and
// groups to finish (counters[first piece], zero when the call starts) adds
// them all into out.
template <typename T, int V, bool ROUND>
__global__ void __launch_bounds__(kThreads)
segsum_sum_kernel(const T* __restrict__ rows, const int* __restrict__ plan, float* __restrict__ out,
                  float* __restrict__ partials, int* __restrict__ counters, int m, int n_rows, int c, int log_pp,
                  int groups) {
  const Layout l = layout(m, n_rows);
  const int* start = plan + l.start;
  const int* order = plan + l.order;
  const int4* pieces = reinterpret_cast<const int4*>(plan + l.pieces);
  const int items = (m + plan[l.n_pieces]) * groups;
  const int lane = threadIdx.x & 31;
  const int pp = 1 << log_pp, slots = 32 >> log_pp;
  const int slot = lane >> log_pp, pl = lane & (pp - 1);
  const int n_pc = c / V;
  const int warps = gridDim.x * (kThreads / 32);
  for (int item = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); item < items; item += warps) {
    const long long t_item = SEG_NOW();
    // most rows are one group wide: no division for them
    const int unit = groups == 1 ? item : item / groups, grp = item - unit * groups;
    int t, s, n;
    int4 piece = make_int4(0, 0, 0, 0);
    if (unit < m) {
      t = unit;
      s = __ldg(start + t);
      n = __ldg(start + t + 1) - s;
      if (n > kLong) continue;  // its pieces are units of their own
    } else {
      piece = __ldg(pieces + (unit - m));
      t = piece.x;
      s = __ldg(start + t) + piece.y * kLong;
      n = min(kLong, __ldg(start + t + 1) - s);
    }
    const bool part = unit >= m;
    float* dst = part ? partials + static_cast<size_t>(piece.z + piece.y) * c : out + static_cast<size_t>(t) * c;
    const int pc = grp * pp + pl;
    const bool on = pc < n_pc;
    long long t_lists = 0, t_rows = 0;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int i0 = slot; i0 < n; i0 += slots * kUnroll) {
      const long long t0 = SEG_NOW();
      int r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * slots;
        r[u] = i < n ? __ldg(order + s + i) : -1;
      }
      const long long t1 = SEG_NOW();
      float x[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] >= 0 && on) {
          load_piece<T, V, ROUND>(rows + static_cast<size_t>(r[u]) * c + static_cast<size_t>(pc) * V, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) x[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += x[u][j];
      }
      t_lists += t1 - t0;
      t_rows += SEG_NOW() - t1;
    }
    for (int off = pp; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (slot == 0 && on) store_piece<V>(dst + static_cast<size_t>(pc) * V, acc);
    if (part) {
      // the last (piece, group) of the target to arrive adds the partials in
      // piece order
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lane == 0) last = atomicAdd(counters + piece.z, 1) == piece.w * groups - 1;
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence();
        const float* src = partials + static_cast<size_t>(piece.z) * c;
        float* o = out + static_cast<size_t>(t) * c;
        for (int e = lane; e < c; e += 32) {
          float sum = 0.f;
          for (int q = 0; q < piece.w; ++q) sum += __ldcg(src + static_cast<size_t>(q) * c + e);
          o[e] = sum;
        }
      }
    }
#ifdef MVKP_CYCLES
    if (lane == 0 && grp == 0) {
      SEG_ADD(0, n);
      SEG_ADD(part ? 2 : 1, 1);
    }
    if (lane == 0) {
      SEG_ADD(3, t_lists);
      SEG_ADD(4, t_rows);
      SEG_ADD(5, SEG_NOW() - t_item - t_lists - t_rows);
    }
#else
    (void)t_item;
    (void)t_lists;
    (void)t_rows;
#endif
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Blocks for a grid-stride walk over `work` items, `per_block` a block a
// round: at most two rounds of 8 resident blocks an SM.
unsigned grid_for(long long work, int per_block) {
  const long long need = (work + per_block - 1) / per_block;
  const long long cap = 16LL * sm_count();
  return static_cast<unsigned>(need < 1 ? 1 : (need < cap ? need : cap));
}

// pp = the pieces of a row, rounded up to a power of two, at most kGroup;
// groups = the items a target's row is split into.
template <typename T, int V, bool ROUND>
cudaError_t launch_sum(const void* rows, const int* plan, float* out, float* partials, int* counters, int m,
                       int n_rows, int c, cudaStream_t stream) {
  const int n_pc = c / V;
  int log_pp = 0;
  while ((1 << log_pp) < n_pc && (1 << log_pp) < kGroup) ++log_pp;
  const int groups = (n_pc + (1 << log_pp) - 1) >> log_pp;
  const long long items = (m + layout(m, n_rows).max_pieces) * static_cast<long long>(groups);
  segsum_sum_kernel<T, V, ROUND><<<grid_for(items, kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const T*>(rows), plan, out, partials, counters, m, n_rows, c, log_pp, groups);
  return cudaGetLastError();
}

// The widest piece that c and the rows' alignment allow (the output is
// 16-byte aligned, and a piece of V floats of it then 4V-byte aligned).
template <typename T, bool ROUND>
cudaError_t dispatch_sum(const void* rows, const int* plan, float* out, float* partials, int* counters, int m,
                         int n_rows, int c, cudaStream_t stream) {
  const uintptr_t rp = reinterpret_cast<uintptr_t>(rows);
  constexpr int es = sizeof(T);
  if (c % (16 / es) == 0 && rp % 16 == 0)
    return launch_sum<T, 16 / es, ROUND>(rows, plan, out, partials, counters, m, n_rows, c, stream);
  if (es == 2 && c % 4 == 0 && rp % 8 == 0)
    return launch_sum<T, 4, ROUND>(rows, plan, out, partials, counters, m, n_rows, c, stream);
  if (c % 2 == 0 && rp % (2 * es) == 0)
    return launch_sum<T, 2, ROUND>(rows, plan, out, partials, counters, m, n_rows, c, stream);
  return launch_sum<T, 1, ROUND>(rows, plan, out, partials, counters, m, n_rows, c, stream);
}

bool sizes_ok(int b, int rows_per_b, int ns) {
  const long long n = static_cast<long long>(b) * rows_per_b, m = static_cast<long long>(b) * ns;
  return b > 0 && rows_per_b > 0 && ns > 0 && layout(m, n).total < (1LL << 31) &&
         sort_layout(n).total < (1LL << 31) && m < (1LL << 30);
}

// Bits of a sort key: keys run from 0 to m (m for rows out of range).
int key_bits(long long m) {
  int bits = 1;
  while ((1LL << bits) <= m) ++bits;
  return bits;
}

template <bool FIRST, bool LAST>
void sort_pass(const int* src, const int* rows_in, int* keys_out, int* rows_out, int* hist, int* offsets,
               int* counts, unsigned n, unsigned rows_per_b, int ns, int m, int shift, int buckets, int tiles,
               cudaStream_t stream) {
  segsum_hist_kernel<FIRST><<<tiles, kThreads, 0, stream>>>(src, hist, counts, n, rows_per_b, ns, m, shift, buckets,
                                                            tiles);
  const int len = buckets * tiles;
  segsum_scan_kernel<false><<<(len + kChunk - 1) / kChunk, kScanThreads, 0, stream>>>(hist, offsets, len, nullptr,
                                                                                       nullptr);
  segsum_scatter_kernel<FIRST, LAST><<<tiles, kThreads, 0, stream>>>(src, rows_in, keys_out, rows_out, offsets, n,
                                                                     rows_per_b, ns, m, shift, buckets, tiles);
}

}  // namespace

// out[0]: ints the plan of an index takes; out[1]: ints of scratch its
// building takes; out[2]: 4-byte words of scratch a sum at width c takes
// (the partial rows of long targets, then a counter each).
extern "C" int mvkp_segsum_sizes(int b, int rows_per_b, int ns, int c, long long* out) {
  if (!sizes_ok(b, rows_per_b, ns) || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(b) * rows_per_b;
  const Layout l = layout(static_cast<long long>(b) * ns, n);
  out[0] = l.total;
  out[1] = sort_layout(n).total;
  out[2] = l.max_pieces * (c + 1);
  return 0;
}

// index: (b * rows_per_b) int32 targets; plan: mvkp_segsum_sizes' out[0]
// ints; scratch: its out[1] ints, free again when the plan's kernels end.
// The plan depends on the index alone, is read only by the sums, and serves
// any number of them.
extern "C" int mvkp_segsum_plan(const int* index, int* plan, int* scratch, int b, int rows_per_b, int ns,
                                cudaStream_t stream) {
  if (!sizes_ok(b, rows_per_b, ns)) return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(b) * ns, n = static_cast<long long>(b) * rows_per_b;
  const Layout l = layout(m, n);
  const SortLayout sl = sort_layout(n);
  const int mi = static_cast<int>(m);
  const unsigned nu = static_cast<unsigned>(n), rpb = static_cast<unsigned>(rows_per_b);
  cudaError_t err = cudaMemsetAsync(plan, 0, sizeof(int) * m, stream);  // the counts
  if (err != cudaSuccess) return static_cast<int>(err);
  // the (key, row) pairs, sorted on the key's bits, passes of equal width;
  // the first pass's histogram also counts the rows of each target
  const int bits = key_bits(m), passes = (bits + kDigit - 1) / kDigit, width = (bits + passes - 1) / passes;
  const int tiles = static_cast<int>(sl.tiles);
  int *keys[2] = {scratch + sl.keys0, scratch + sl.keys1}, *rows[2] = {scratch + sl.rows0, scratch + sl.rows1};
  int* hist = scratch + sl.hist;
  int* offsets = scratch + sl.offsets;
  int* order = plan + l.order;
  for (int p = 0; p < passes; ++p) {
    const bool last = p + 1 == passes;
    int* rows_out = last ? order : rows[p & 1];
    if (p == 0 && last)
      sort_pass<true, true>(index, nullptr, nullptr, rows_out, hist, offsets, plan, nu, rpb, ns, mi, 0, 1 << width,
                            tiles, stream);
    else if (p == 0)
      sort_pass<true, false>(index, nullptr, keys[0], rows_out, hist, offsets, plan, nu, rpb, ns, mi, 0, 1 << width,
                             tiles, stream);
    else if (last)
      sort_pass<false, true>(keys[(p - 1) & 1], rows[(p - 1) & 1], nullptr, rows_out, hist, offsets, nullptr, nu, rpb,
                             ns, mi, p * width, 1 << width, tiles, stream);
    else
      sort_pass<false, false>(keys[(p - 1) & 1], rows[(p - 1) & 1], keys[p & 1], rows_out, hist, offsets, nullptr, nu,
                              rpb, ns, mi, p * width, 1 << width, tiles, stream);
  }
  segsum_scan_kernel<true><<<static_cast<unsigned>((m + kChunk - 1) / kChunk), kScanThreads, 0, stream>>>(
      plan, plan + l.start, mi, reinterpret_cast<int4*>(plan + l.pieces), plan + l.n_pieces);
  return static_cast<int>(cudaGetLastError());
}

// rows: (b * rows_per_b, c) f32 or bf16, row-major, any alignment of its
// element type; plan: mvkp_segsum_plan's for this index; out: (b * ns, c)
// f32, 16-byte aligned, written whole; scratch: mvkp_segsum_sizes' out[2]
// words. round_bf16 rounds f32 rows to bf16 before the sum (ignored for bf16
// rows).
extern "C" int mvkp_segsum_sum(const void* rows, int rows_is_bf16, int round_bf16, const int* plan, float* out,
                               void* scratch, int b, int rows_per_b, int ns, int c, cudaStream_t stream) {
  const long long n = static_cast<long long>(b) * rows_per_b, m = static_cast<long long>(b) * ns;
  if (!sizes_ok(b, rows_per_b, ns) || c <= 0 || n * c >= (1LL << 31) || m * c >= (1LL << 31) ||
      layout(m, n).max_pieces * (c + 1) >= (1LL << 31) || (m + layout(m, n).max_pieces) * c >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long max_pieces = layout(m, n).max_pieces;
  float* partials = static_cast<float*>(scratch);
  int* counters = reinterpret_cast<int*>(partials + max_pieces * c);
  const cudaError_t err = cudaMemsetAsync(counters, 0, sizeof(int) * max_pieces, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mi = static_cast<int>(m), ni = static_cast<int>(n);
  if (rows_is_bf16)
    return static_cast<int>(
        dispatch_sum<__nv_bfloat16, false>(rows, plan, out, partials, counters, mi, ni, c, stream));
  if (round_bf16)
    return static_cast<int>(dispatch_sum<float, true>(rows, plan, out, partials, counters, mi, ni, c, stream));
  return static_cast<int>(dispatch_sum<float, false>(rows, plan, out, partials, counters, mi, ni, c, stream));
}

#ifdef MVKP_CYCLES
// out[6]: see segsum_counts. The counts since the last call; they start again.
extern "C" int mvkp_segsum_counts(unsigned long long* out) {
  const unsigned long long zero[6] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, segsum_counts, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(segsum_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
