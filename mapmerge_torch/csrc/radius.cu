// The dense radius sweeps for Hopper (sm_90a): the neighbour count (kernel
// E) and the neighbourhood moments (kernel F) of each query over the valid
// points within a radius.
//
// Neither replaces a Pallas kernel: the JAX package leaves both to XLA.
// Kernel E replaces the dense branch of mapmerge_tpu/ops/neighbors.py
// `radius_count` (outlier removal, SC3D's density), kernel F that of
// `neighbor_moments` (surface normals). Their plain PyTorch versions are
// kernels/radius.py: count_ref and moments_ref.
//
// What they compute. A point p is a member of query q's neighbourhood when
// it is valid and sq_dist(q, p) <= r2, sq_dist being ops/neighbors.sq_dists
// bit for bit (cull.cuh), so both kernels take the plain version's members.
// Kernel E (mm_radius_count): the number of members, int32, exact.
// Kernel F (mm_radius_moments): s0 = the number of members, s1 = the sum of
// their coordinates and s2 = the sum of p_i * p_j (each product rounded
// once: the plain version's `pp` term; six sums, mirrored to nine), then
// the plain version's epilogue: denom = max(s0, 1), mean = s1 / denom, e =
// s2 / denom, cov = e - mean_i * mean_j, each operation rounded once. The
// sums run in another order than the plain version's matrix products, so
// the two agree to rounding (kernels/radius.py states the tolerance); the
// count is exact.
//
// What bounds them. Swept densely, every (query, point) pair costs the
// distance and a compare on the CUDA cores, though at config #1's radii
// (0.8 and 0.6 m at 0.1 m voxels) under 2% of the pairs are members. With
// culling the pairs left take a few microseconds of the card's float32
// rate; what a call costs is its fixed part (the host's calls, launches)
// and each warp's chain of tile visits, one dependent load and test after
// another. Hence:
// 1. One C call a call, one launch up to the cutoff. A cloud of up to
//    kResidentMax points takes the resident route, resident_kernel: a
//    persistent grid whose every CTA copies the whole cloud into shared
//    memory with cp.async (12 B a point), folds the mask into it (x = NaN
//    where masked), builds the boxes of its tiles (kT consecutive points)
//    and super-tiles (kSuper tiles) there, and sweeps its share of the
//    queries out of shared memory, with no pre-pass and no global buffer,
//    the cloud in the caller's order. A larger cloud takes the streamed
//    route: order_kernel writes the points and the boxes into the caller's
//    workspace (tiles.cu's layout for the points and tiles, which SIFT's C
//    and D keep), each chunk of kChunk points sorted by the Morton code of
//    its cells of r / kCells, then streamed_kernel reads them through
//    cull.cuh's cp.async ring. The feature stage's voxel order (x, then y,
//    then z) makes a tile a slab one voxel thick across y and z (0.09 x
//    1.31 x 1.68 m on config #1's first view); the Morton order makes it a
//    compact box, and a query reaches fewer tiles (a numpy model of that
//    view: 763 against 1,288 pairs compared a query at 0.8 m, 531 against
//    931 at 0.6 m). The sort costs ~8 us a call (one CTA a chunk), and on
//    an H100 at 700 W it pays between 8,192 and 12,288 points (E and F on
//    the device, the resident route in the caller's order against the
//    streamed route: 21 and 25 us against 26 and 30 at 8,192 points, 39
//    and 44 against 32 and 34 at 12,288), hence the cutoff.
// 2. Exact culling by boxes, two levels: a warp tests 32 super-tiles at
//    once, one a lane, against the box of its queries and each query, then
//    the 32 tiles of each super-tile that passes; a tile that none of its
//    queries reaches is not read. A warp of queries parked at FAR reads the
//    super-tiles' boxes and no point.
// 3. kLanes lanes share a query, lane g of them the points j = g (mod
//    kLanes) of each tile, all tested at once with no branch; a warp's 4
//    queries share its tiles. E's lanes add their counts (integers: exact in
//    any order). F's lanes each sum their members in tile order, and the
//    kLanes partial sums are added in a fixed tree, so a run repeats bit
//    for bit and F's bits do not depend on the card; they depend on the
//    route's order of the points, which the points alone fix. On the
//    resident route they are those of the culled sweep before it (the
//    caller's order, 8 parts): a tile none of a warp's queries reaches
//    holds none of their members, so culling more moves no sum. (32 lanes,
//    a query a warp, were no faster on the device at 4,096 and 8,192
//    points, 17-25 us, and their sums' new rounding moved config5's drift
//    past its 10 deg gate.)
// The queries may be any points, not only the cloud's own.
// No FMA contraction (-fmad=false), no atomics, no fast-math.

#include <algorithm>

#include "cull.cuh"

namespace {

constexpr int kLanes = 8;              // lanes that share a query (kernels/radius.py LANES)
constexpr int kPerWarp = 32 / kLanes;  // queries a warp
constexpr int kMine = kT / kLanes;     // points of a tile a lane tests
constexpr int kSuper = 32;  // tiles a super-tile: one a lane
// the resident route: clouds of up to kResidentMax points (kernels/radius.py
// RESIDENT_MAX_POINTS), kResWarps warps a CTA
constexpr int kResidentMax = 8192;
constexpr int kResWarps = 8;
constexpr int kResThreads = kResWarps * 32;
// the streamed route's order: chunks of kChunk points (kernels/radius.py
// ORDER_CHUNK; a super-tile each), each sorted by the Morton code of its
// cells of r / kCells (ORDER_CELLS), kCodeBits bits an axis, one key a thread
constexpr int kChunk = kSuper * kT;
constexpr float kCells = 8.f;
constexpr int kCodeBits = 10;

// ---- what E and F do with a query's members ----

// E: the number of members, added over the lanes of a query
struct CountOp {
  int* out;
  struct Acc {
    int n;
  };
  __device__ Acc init() const { return {0}; }
  template <class Get>
  __device__ void add(Acc& a, unsigned in, Get) const {
    a.n += __popc(in);
  }
  __device__ void finish(Acc& a, bool active, int g, long long qi) const {
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) a.n += __shfl_xor_sync(kAll, a.n, o);
    if (active && g == 0) out[qi] = a.n;
  }
};

// F: the count and the nine sums s1 (x, y, z), s2 (xx, xy, xz, yy, yz, zz),
// each lane's in its members' order, then the lanes' in a fixed tree; out
// holds count (nq), mean (nq, 3) and cov (nq, 3, 3) one after another
struct MomentsOp {
  float* out;
  long long nq;
  struct Acc {
    int n;
    float s[9];
  };
  __device__ Acc init() const {
    Acc a;
    a.n = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) a.s[k] = 0.f;
    return a;
  }
  template <class Get>
  __device__ void add(Acc& a, unsigned in, Get get) const {
    a.n += __popc(in);
    while (in != 0) {  // this lane's members, in order
      const int i = __ffs(static_cast<int>(in)) - 1;
      in &= in - 1;
      const float3 t = get(i);
      a.s[0] = __fadd_rn(a.s[0], t.x);
      a.s[1] = __fadd_rn(a.s[1], t.y);
      a.s[2] = __fadd_rn(a.s[2], t.z);
      a.s[3] = __fadd_rn(a.s[3], __fmul_rn(t.x, t.x));
      a.s[4] = __fadd_rn(a.s[4], __fmul_rn(t.x, t.y));
      a.s[5] = __fadd_rn(a.s[5], __fmul_rn(t.x, t.z));
      a.s[6] = __fadd_rn(a.s[6], __fmul_rn(t.y, t.y));
      a.s[7] = __fadd_rn(a.s[7], __fmul_rn(t.y, t.z));
      a.s[8] = __fadd_rn(a.s[8], __fmul_rn(t.z, t.z));
    }
  }
  __device__ void finish(Acc& a, bool active, int g, long long qi) const {
    // the kLanes partial sums, in a tree every lane of the query computes
    // alike (a + b and b + a round alike)
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      a.n += __shfl_xor_sync(kAll, a.n, o);
#pragma unroll
      for (int k = 0; k < 9; ++k) a.s[k] = __fadd_rn(a.s[k], __shfl_xor_sync(kAll, a.s[k], o));
    }
    if (!active || g != 0) return;
    const float s0 = static_cast<float>(a.n);  // exact below 2^24
    const float denom = fmaxf(s0, 1.f);
    const float m[3] = {__fdiv_rn(a.s[0], denom), __fdiv_rn(a.s[1], denom),
                        __fdiv_rn(a.s[2], denom)};
    // s2's slot of entry (i, j) of the 3 x 3 matrix
    constexpr int kSlot[3][3] = {{3, 4, 5}, {4, 6, 7}, {5, 7, 8}};
    float* mean = out + nq;
    float* cov = out + 4 * nq;
    out[qi] = s0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mean[3 * qi + i] = m[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cov[9 * qi + 3 * i + j] =
            __fsub_rn(__fdiv_rn(a.s[kSlot[i][j]], denom), __fmul_rn(m[i], m[j]));
      }
    }
  }
};

// ---- the culling, shared by both routes ----

// The calling lane's query qi of a warp's kPerWarp (NaN where past nq: an
// idle lane, within r2 of no point).
struct Query {
  long long qi;
  bool active;
  float x, y, z;
};

__device__ __forceinline__ Query load_query(const float* __restrict__ q, int nq,
                                            long long first, int lane) {
  Query r;
  r.qi = first + lane / kLanes;
  r.active = r.qi < nq;
  const float nan = __int_as_float(0x7fc00000);
  r.x = r.active ? q[3 * r.qi] : nan;
  r.y = r.active ? q[3 * r.qi + 1] : nan;
  r.z = r.active ? q[3 * r.qi + 2] : nan;
  return r;
}

// The warp's queries: their box, and each in every lane (an idle one
// inactive).
struct Table {
  Box box;
  float x[kPerWarp], y[kPerWarp], z[kPerWarp];
  bool active[kPerWarp];
};

__device__ __forceinline__ Table table_of(const Query& me) {
  Table tab;
  tab.box = warp_box(me.active, me.x, me.y, me.z);
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
    tab.x[k] = __shfl_sync(kAll, me.x, k * kLanes);
    tab.y[k] = __shfl_sync(kAll, me.y, k * kLanes);
    tab.z[k] = __shfl_sync(kAll, me.z, k * kLanes);
    tab.active[k] = __shfl_sync(kAll, me.active, k * kLanes);
  }
  return tab;
}

// Of the 32 boxes pos + lane (those past n not at all), the ones that the
// box of the warp's queries and one of its queries reach: a ballot.
// box(i, lo, hi) gives box i.
template <class BoxOf>
__device__ __forceinline__ unsigned reached(const Table& tab, int pos, int n, float r2,
                                            int lane, BoxOf box) {
  const int i = pos + lane;
  bool reach = false;
  if (i < n) {
    float4 lo, hi;
    box(i, lo, hi);
    if (boxes_bound(tab.box, lo, hi) <= r2) {
#pragma unroll
      for (int k = 0; k < kPerWarp && !reach; ++k) {
        reach = tab.active[k] && box_bound(tab.x[k], tab.y[k], tab.z[k], lo, hi) <= r2;
      }
    }
  }
  return __ballot_sync(kAll, reach);
}

// The tiles a warp visits, in index order, one a call (warp-uniform; -1
// when none is left): the super-tiles (kSuper tiles each) that its queries
// reach, 32 tested at once, and in each the tiles that they reach.
template <class SuperOf, class TileOf>
struct Visits {
  const Table& tab;
  int nsuper, ntiles;
  float r2;
  int lane;
  SuperOf super;
  TileOf tile;
  int spos = 0, sbase = 0, tbase = 0;
  unsigned skeep = 0, tkeep = 0;

  __device__ __forceinline__ int operator()() {
    while (tkeep == 0) {
      while (skeep == 0) {
        if (spos >= nsuper) return -1;
        skeep = reached(tab, spos, nsuper, r2, lane, super);
        sbase = spos;
        spos += 32;
      }
      tbase = (sbase + __ffs(static_cast<int>(skeep)) - 1) * kSuper;
      skeep &= skeep - 1;
      tkeep = reached(tab, tbase, ntiles, r2, lane, tile);
    }
    const int t = tbase + __ffs(static_cast<int>(tkeep)) - 1;
    tkeep &= tkeep - 1;
    return t;
  }
};

template <class SuperOf, class TileOf>
__device__ __forceinline__ Visits<SuperOf, TileOf> visits(const Table& tab, int nsuper,
                                                          int ntiles, float r2, int lane,
                                                          SuperOf super, TileOf tile) {
  return Visits<SuperOf, TileOf>{tab, nsuper, ntiles, r2, lane, super, tile};
}

// ---- the resident route ----

// shared memory of a cloud of np points: the coordinates (3 floats a point,
// ntiles * kT points), its mask (a byte a point, to 16 bytes), then the
// boxes of the tiles and of the super-tiles, each as six float arrays (least
// x, y, z, largest x, y, z)
__host__ __device__ constexpr long long mask_offset(int np) {
  return (static_cast<long long>(np) + kT - 1) / kT * kT * 12LL;
}
__host__ __device__ constexpr long long boxes_offset(int np) {
  return mask_offset(np) + (static_cast<long long>(np) + kT - 1) / kT * kT;
}
__host__ __device__ constexpr long long resident_bytes(int np) {
  return boxes_offset(np) + (static_cast<long long>(np) + kT - 1) / kT * 24LL +
         (static_cast<long long>(np) + kChunk - 1) / kChunk * 24LL;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void box_at(const float* b, int n, int i, float4& lo, float4& hi) {
  lo = make_float4(b[i], b[n + i], b[2 * n + i], 0.f);
  hi = make_float4(b[3 * n + i], b[4 * n + i], b[5 * n + i], 0.f);
}

__device__ __forceinline__ void put_box(float* b, int n, int i, const Box& v) {
  b[i] = v.lx;
  b[n + i] = v.ly;
  b[2 * n + i] = v.lz;
  b[3 * n + i] = v.hx;
  b[4 * n + i] = v.hy;
  b[5 * n + i] = v.hz;
}

__device__ __forceinline__ void grow(Box& b, float lx, float ly, float lz, float hx, float hy,
                                     float hz) {
  b.lx = fminf(b.lx, lx);
  b.ly = fminf(b.ly, ly);
  b.lz = fminf(b.lz, lz);
  b.hx = fmaxf(b.hx, hx);
  b.hy = fmaxf(b.hy, hy);
  b.hz = fmaxf(b.hz, hz);
}

template <class Op>
__global__ void __launch_bounds__(kResThreads)
resident_kernel(const float* __restrict__ p, const unsigned char* __restrict__ mask,
                int np, const float* __restrict__ q, int nq, float r2, Op op) {
  extern __shared__ float4 smem[];
  const int ntiles = (np + kT - 1) / kT;
  const int nsuper = (ntiles + kSuper - 1) / kSuper;
  const int npad = ntiles * kT;
  float* xyz = reinterpret_cast<float*>(smem);
  unsigned char* valid = reinterpret_cast<unsigned char*>(smem) + mask_offset(np);
  float* tb = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) +
                                       boxes_offset(np));  // the tiles' boxes
  float* sb = tb + 6LL * ntiles;                            // the super-tiles' boxes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // 1. the cloud and its mask into shared memory: 16-byte copies where the
  // source is aligned so, 4-byte ones (bytes for the mask) for the rest
  const int words = 3 * np;
  int head = 0;
  if ((reinterpret_cast<unsigned long long>(p) & 15) == 0) {
    head = words & ~3;
    for (int v = tid; v < head / 4; v += kResThreads) cp_async16(xyz + 4 * v, p + 4 * v);
  }
  for (int w = head + tid; w < words; w += kResThreads) cp_async4(xyz + w, p + w);
  if (mask != nullptr) {
    int mhead = 0;
    if ((reinterpret_cast<unsigned long long>(mask) & 15) == 0) {
      mhead = np & ~15;
      for (int v = tid; v < mhead / 16; v += kResThreads) {
        cp_async16(valid + 16 * v, mask + 16 * v);
      }
    }
    for (int j = mhead + tid; j < np; j += kResThreads) valid[j] = mask[j];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // 2. a thread a tile: the mask folded in (x = NaN where masked, the rows
  // past np NaN) and the box of its valid points; then a thread a
  // super-tile, the box of its tiles' boxes (min and max are exact in any
  // order; none: lo = +inf, hi = -inf). Lane l starts at point (or tile) l
  // of its 32, so the lanes of a warp read 32 banks.
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  for (int t = tid; t < ntiles; t += kResThreads) {
    Box b{inf, inf, inf, -inf, -inf, -inf};
    for (int i = 0; i < kT; ++i) {
      const int j = t * kT + ((i + lane) & (kT - 1));
      float* pt = xyz + 3 * j;
      if (j >= np) {
        pt[0] = nan;
        pt[1] = 0.f;
        pt[2] = 0.f;
      } else if (mask != nullptr && valid[j] == 0) {
        pt[0] = nan;
      } else if (!isnan(pt[0])) {
        grow(b, pt[0], pt[1], pt[2], pt[0], pt[1], pt[2]);
      }
    }
    put_box(tb, ntiles, t, b);
  }
  __syncthreads();
  for (int s = tid; s < nsuper; s += kResThreads) {
    Box b{inf, inf, inf, -inf, -inf, -inf};
    for (int i = 0; i < kSuper; ++i) {
      const int t = s * kSuper + ((i + lane) & (kSuper - 1));
      if (t < ntiles) {
        grow(b, tb[t], tb[ntiles + t], tb[2 * ntiles + t], tb[3 * ntiles + t],
             tb[4 * ntiles + t], tb[5 * ntiles + t]);
      }
    }
    put_box(sb, nsuper, s, b);
  }
  __syncthreads();

  // 3. the queries, kResWarps * kPerWarp a CTA step, out of shared memory
  const int g = lane % kLanes;
  const long long per_step = static_cast<long long>(kResWarps) * kPerWarp;
  for (long long first = blockIdx.x * per_step; first < nq; first += gridDim.x * per_step) {
    const Query me = load_query(q, nq, first + warp * kPerWarp, lane);
    const Table tab = table_of(me);
    auto acc = op.init();
    if (tab.box.lx <= tab.box.hx) {  // warp-uniform: a warp with an active query
      auto next = visits(
          tab, nsuper, ntiles, r2, lane,
          [&](int i, float4& lo, float4& hi) { box_at(sb, nsuper, i, lo, hi); },
          [&](int i, float4& lo, float4& hi) { box_at(tb, ntiles, i, lo, hi); });
      for (int t = next(); t >= 0; t = next()) {
        const float* pt0 = xyz + 3LL * (t * kT + g);
        unsigned in = 0;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float* pt = pt0 + 3 * i * kLanes;
          // false for NaN: a masked point, a row past np, or an idle lane
          in |= static_cast<unsigned>(sq_dist(me.x, me.y, me.z, pt[0], pt[1], pt[2]) <= r2)
                << i;
        }
        op.add(acc, in, [&](int i) {
          const float* pt = pt0 + 3 * i * kLanes;
          return make_float3(pt[0], pt[1], pt[2]);
        });
      }
    }
    op.finish(acc, me.active, g, me.qi);
  }
}

// ---- the streamed route ----

// spread the low kCodeBits bits of v to every third bit
__device__ __forceinline__ unsigned long long spread3(unsigned v) {
  unsigned long long x = v & ((1u << kCodeBits) - 1);
  x = (x | (x << 16)) & 0x30000ffull;
  x = (x | (x << 8)) & 0x300f00full;
  x = (x | (x << 4)) & 0x30c30c3ull;
  x = (x | (x << 2)) & 0x9249249ull;
  return x;
}

// the cell of coordinate x above the chunk's least lo, in [0, 2^kCodeBits):
// floor((x - lo) * inv), NaN and below 0 to 0, clamped at the top
__device__ __forceinline__ unsigned cell_of(float x, float lo, float inv) {
  float c = floorf(__fmul_rn(__fsub_rn(x, lo), inv));
  c = c >= 0.f ? c : 0.f;
  c = fminf(c, static_cast<float>((1 << kCodeBits) - 1));
  return static_cast<unsigned>(c);
}

// One CTA a chunk of kChunk points, one a thread: the chunk's box of its
// valid points (its super-tile's), each point's key (the Morton code of the
// cells of a valid point, 2^(3 kCodeBits) for a masked or absent one, then
// its place in the chunk: all distinct), the keys sorted (bitonic: shuffles
// within a warp, shared memory across), the points written in that order
// as float4 (x = NaN where masked or absent, w = 0) and each tile's box
// (tiles.cu's layout; w = 0), then the super-tile's box.
__global__ void __launch_bounds__(kChunk)
order_kernel(const float* __restrict__ p, const unsigned char* __restrict__ mask, int np,
             float inv, float4* __restrict__ pts, float4* __restrict__ boxes,
             float4* __restrict__ supers) {
  __shared__ unsigned long long swap[2][kChunk];
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ Box part[kChunk / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long j = static_cast<long long>(blockIdx.x) * kChunk + tid;
  const float nan = __int_as_float(0x7fc00000);
  const bool in = j < np;
  const float x = in ? p[3 * j] : 0.f, y = in ? p[3 * j + 1] : 0.f, z = in ? p[3 * j + 2] : 0.f;
  // a point whose x is NaN is within r2 of no query: masked alike
  const bool valid = in && (mask == nullptr || mask[j] != 0) && !isnan(x);
  sx[tid] = valid ? x : nan;
  sy[tid] = y;
  sz[tid] = z;
  Box b = warp_box(valid, x, y, z);  // fminf / fmaxf pass over a NaN y or z
  if (lane == 0) part[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = part[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      b.lx = fminf(b.lx, __shfl_xor_sync(kAll, b.lx, o));
      b.ly = fminf(b.ly, __shfl_xor_sync(kAll, b.ly, o));
      b.lz = fminf(b.lz, __shfl_xor_sync(kAll, b.lz, o));
      b.hx = fmaxf(b.hx, __shfl_xor_sync(kAll, b.hx, o));
      b.hy = fmaxf(b.hy, __shfl_xor_sync(kAll, b.hy, o));
      b.hz = fmaxf(b.hz, __shfl_xor_sync(kAll, b.hz, o));
    }
    if (lane == 0) part[0] = b;
  }
  __syncthreads();
  const Box chunk = part[0];
  unsigned long long key = 1ull << (3 * kCodeBits);
  if (valid) {
    key = spread3(cell_of(x, chunk.lx, inv)) << 2 | spread3(cell_of(y, chunk.ly, inv)) << 1 |
          spread3(cell_of(z, chunk.lz, inv));
  }
  key = key << 10 | static_cast<unsigned long long>(tid);  // kChunk = 2^10
  int buf = 0;
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      unsigned long long other;
      if (s < 32) {
        other = __shfl_xor_sync(kAll, key, s);
      } else {
        swap[buf][tid] = key;
        __syncthreads();
        other = swap[buf][tid ^ s];
        buf ^= 1;  // the next write goes to the other buffer: one barrier a step
      }
      // the lower of the pair keeps the least where the run ascends
      const bool keep_min = ((tid & s) == 0) == ((tid & k) == 0);
      key = keep_min ? (other < key ? other : key) : (other > key ? other : key);
    }
  }
  // the point at this sorted place; a tile a warp
  const int from = static_cast<int>(key & (kChunk - 1));
  const bool live = !isnan(sx[from]);
  const long long row = static_cast<long long>(blockIdx.x) * kChunk + tid;
  pts[row] = make_float4(sx[from], sy[from], sz[from], 0.f);
  b = warp_box(live, sx[from], sy[from], sz[from]);
  if (lane == 0) {
    const long long tile = row / kT;
    boxes[2 * tile] = make_float4(b.lx, b.ly, b.lz, 0.f);
    boxes[2 * tile + 1] = make_float4(b.hx, b.hy, b.hz, 0.f);
  }
  if (tid == 0) {
    supers[2LL * blockIdx.x] = make_float4(chunk.lx, chunk.ly, chunk.lz, 0.f);
    supers[2LL * blockIdx.x + 1] = make_float4(chunk.hx, chunk.hy, chunk.hz, 0.f);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
streamed_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
                const float4* __restrict__ supers, int ntiles, const float* __restrict__ q,
                int nq, float r2, Op op) {
  __shared__ Stage ring[kWarps][kStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % kLanes;
  const Query me = load_query(
      q, nq, (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPerWarp, lane);
  const Table tab = table_of(me);
  auto acc = op.init();
  if (tab.box.lx <= tab.box.hx) {  // warp-uniform: a warp with an active query
    auto next = visits(
        tab, (ntiles + kSuper - 1) / kSuper, ntiles, r2, lane,
        [&](int i, float4& lo, float4& hi) {
          lo = supers[2LL * i];
          hi = supers[2LL * i + 1];
        },
        [&](int i, float4& lo, float4& hi) {
          lo = boxes[2LL * i];
          hi = boxes[2LL * i + 1];
        });
    sweep(ring[warp], next, [&](Stage& st, int t) { issue(st, pts, boxes, t, lane); },
          [&](const Stage& st) {
      unsigned in = 0;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 t = st.pt[g + i * kLanes];
        // false for NaN: a masked point, a row past np, or an idle lane
        in |= static_cast<unsigned>(sq_dist(me.x, me.y, me.z, t.x, t.y, t.z) <= r2) << i;
      }
      op.add(acc, in, [&](int i) {
        const float4 t = st.pt[g + i * kLanes];
        return make_float3(t.x, t.y, t.z);
      });
    });
  }
  op.finish(acc, me.active, g, me.qi);
}

// the points of the workspace: np rounded up to a chunk
long long padded(int np) { return (static_cast<long long>(np) + kChunk - 1) / kChunk * kChunk; }

int launch_order(const float* p, const unsigned char* mask, int np, float r2, float* work,
                 cudaStream_t stream) {
  const long long npad = padded(np);
  float4* pts = reinterpret_cast<float4*>(work);
  order_kernel<<<static_cast<unsigned>(npad / kChunk), kChunk, 0, stream>>>(
      p, mask, np, kCells / sqrtf(r2), pts, pts + npad, pts + npad + npad / kT * 2);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E or F whole: the resident route up to kResidentMax points, else
// the order pre-pass into `work` and the streamed sweep.
template <class Op>
int launch(const Op& op, const float* p, const unsigned char* mask, int np, const float* q,
           int nq, float r2, float* work, void* stream_ptr) {
  if (nq < 1 || np < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (np <= kResidentMax) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // per device, once: the shared memory limit raised, and the CTAs the
    // card holds at once by their registers and threads alone
    static long long ctas[64] = {0}, sms[64] = {0};
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (ctas[dev] == 0) {
      err = cudaFuncSetAttribute(resident_kernel<Op>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(resident_bytes(kResidentMax)));
      if (err != cudaSuccess) return static_cast<int>(err);
      int n = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<Op>,
                                                          kResThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      sms[dev] = n;
      ctas[dev] = static_cast<long long>(n) * std::max(per_sm, 1);
    }
    const long long bytes = resident_bytes(np);
    // and by shared memory at this size (228 KB an SM, 1 KB of it a CTA's):
    // each CTA loads the cloud once, so no more CTAs than fit at once
    const long long per_sm = std::max(1LL, 233472LL / (bytes + 1024));
    constexpr int per_step = kResWarps * kPerWarp;
    const long long steps = (nq + per_step - 1) / per_step;
    const long long blocks = std::min({steps, ctas[dev], sms[dev] * per_sm});
    resident_kernel<Op><<<static_cast<unsigned>(blocks), kResThreads, bytes, stream>>>(
        p, mask, np, q, nq, r2, op);
    return static_cast<int>(cudaGetLastError());
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_order(p, mask, np, r2, work, stream);
  if (err != 0) return err;
  const long long npad = padded(np);
  const float4* pts = reinterpret_cast<const float4*>(work);
  constexpr int per_block = kPerWarp * kWarps;
  streamed_kernel<Op><<<static_cast<unsigned>((nq + per_block - 1) / per_block), kThreads, 0,
                        stream>>>(pts, pts + npad, pts + npad + npad / kT * 2,
                                  (np + kT - 1) / kT, q, nq, r2, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p (np, 3) f32 centred, mask (np,) bool or null (all valid), q (nq, 3) f32
// centred alike, r2 the float32 squared radius. work: null up to
// kResidentMax points (the resident route), else the order pre-pass's
// points, tile boxes and super-tile boxes (kernels/radius.py work_floats)
// f32. Each returns cudaGetLastError() after its last launch.

// Kernel E: out (nq,) i32, the members of each query.
extern "C" int mm_radius_count(const float* p, const unsigned char* mask, int np,
                               const float* q, int nq, float r2, int* out, float* work,
                               void* stream) {
  return launch(CountOp{out}, p, mask, np, q, nq, r2, work, stream);
}

// Kernel F: out (13 nq,) f32: count (nq,), then mean (nq, 3), then cov
// (nq, 3, 3), in the centred frame.
extern "C" int mm_radius_moments(const float* p, const unsigned char* mask, int np,
                                 const float* q, int nq, float r2, float* out, float* work,
                                 void* stream) {
  return launch(MomentsOp{out, nq}, p, mask, np, q, nq, r2, work, stream);
}

// The streamed route's pre-pass alone (kernels/radius.py `order`), into
// work for any np >= 1.
extern "C" int mm_radius_order(const float* p, const unsigned char* mask, int np, float r2,
                               float* work, void* stream) {
  if (np < 1 || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_order(p, mask, np, r2, work, static_cast<cudaStream_t>(stream));
}
