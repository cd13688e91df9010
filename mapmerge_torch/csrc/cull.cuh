// The tile culling shared by the dense-neighbourhood kernels of sift.cu
// (C and D) and radius.cu (E and F), and the tile shape of their pre-pass
// (tiles.cu): the shape of a tile and of a warp's ring, the distance and its box bounds, and the cp.async ring that brings
// the tiles a warp visits into shared memory. The grid's kernels (grid.cu:
// G-K) take the distance, the box bounds, the tile width, the ring and
// (G and K) the (d2, index) lists from here too.
//
// The points come from tiles.cu's pre-pass (mm_tiles_pack; radius.cu's
// order pre-pass writes the same points and boxes, w = 0): float4 (x, y, z,
// w) with x = NaN where masked, and for each tile of kT consecutive points
// the box of its valid points (lo, hi), the tile's first masked index (lo.w)
// and its first point index (hi.w), as int bits. sq_dist is the direct
// expansion of ops/neighbors.sq_dists, ((dx^2 + dy^2) + dz^2) through
// __fsub_rn / __fmul_rn / __fadd_rn, so it is that function's value bit for
// bit. The box bounds take the same rounded operations on the point of the
// box nearest the query (or on the gap between two boxes): rounding is
// monotone, so a bound is <= sq_dist to every valid point of its tile, with
// no epsilon, and a tile whose bound exceeds a query's threshold holds no
// point within it. Each .cu that includes this header is its own library
// (kernels/build.py), so its definitions sit in an unnamed namespace.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;         // points a tile: one a lane
constexpr int kStages = 4;     // ring stages a warp (a power of two)
constexpr int kWarps = 4;      // warps a block, each on its own queries
constexpr int kThreads = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;

// one tile in shared memory: its points and its box
struct Stage {
  float4 pt[kT];
  float4 lo;  // w: first masked index of the tile (int bits), INT_MAX if none
  float4 hi;  // w: the tile's first point index (int bits)
};

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float px,
                                         float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// <= sq_dist(q, t) for every t in [lo, hi]: the same operations on the
// point of the box nearest to q (an empty box, lo > hi, gives +inf)
__device__ __forceinline__ float box_bound(float qx, float qy, float qz, float4 lo,
                                           float4 hi) {
  return sq_dist(qx, qy, qz, fminf(fmaxf(qx, lo.x), hi.x),
                 fminf(fmaxf(qy, lo.y), hi.y), fminf(fmaxf(qz, lo.z), hi.z));
}

// the gap between [alo, ahi] and [blo, bhi], rounded as sq_dist's
// subtraction rounds q - t for q in the one and t in the other: no larger
__device__ __forceinline__ float gap(float alo, float ahi, float blo, float bhi) {
  return ahi < blo ? __fsub_rn(blo, ahi) : (bhi < alo ? __fsub_rn(alo, bhi) : 0.f);
}

// <= box_bound(q, lo, hi) for every q in the query box `b`
__device__ __forceinline__ float boxes_bound(const Box& b, float4 lo, float4 hi) {
  const float gx = gap(b.lx, b.hx, lo.x, hi.x);
  const float gy = gap(b.ly, b.hy, lo.y, hi.y);
  const float gz = gap(b.lz, b.hz, lo.z, hi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// the box of the active lanes' queries (empty, lx = +inf, if none)
__device__ __forceinline__ Box warp_box(bool active, float x, float y, float z) {
  const float inf = __int_as_float(0x7f800000);
  Box b{active ? x : inf, active ? y : inf, active ? z : inf,
        active ? x : -inf, active ? y : -inf, active ? z : -inf};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.lx = fminf(b.lx, __shfl_xor_sync(kAll, b.lx, o));
    b.ly = fminf(b.ly, __shfl_xor_sync(kAll, b.ly, o));
    b.lz = fminf(b.lz, __shfl_xor_sync(kAll, b.lz, o));
    b.hx = fmaxf(b.hx, __shfl_xor_sync(kAll, b.hx, o));
    b.hy = fmaxf(b.hy, __shfl_xor_sync(kAll, b.hy, o));
    b.hz = fmaxf(b.hz, __shfl_xor_sync(kAll, b.hz, o));
  }
  return b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile t (its points, and its box) into stage `st`, one float4 a lane
__device__ __forceinline__ void issue(Stage& st, const float4* __restrict__ pts,
                                      const float4* __restrict__ boxes, int t,
                                      int lane) {
  cp_async16(&st.pt[lane], pts + static_cast<long long>(t) * kT + lane);
  if (lane < 2) cp_async16(lane == 0 ? &st.lo : &st.hi, boxes + 2LL * t + lane);
}

// whether next() gave a tile: a tile index (-1: none), or a {code, count}
// pair (code -1: none)
__device__ __forceinline__ bool live(int t) { return t >= 0; }
__device__ __forceinline__ bool live(int2 t) { return t.x >= 0; }

// The warp's ring over stages of any type S: next() gives the next tile to
// visit (warp-uniform; none, as live() tells, when none is left, and from
// then on), issue(stage, tile) starts its copies into a stage (issue()
// above for the pre-pass's tiles, grid.cu's issue_tile for a grid's),
// consume(stage) computes on a tile that has arrived. While the warp
// computes on one tile, kStages - 1 more are in flight. Every lane commits
// one copy group a step, empty or not, so wait_group kStages - 1 finds the
// oldest tile in.
template <class S, class Next, class Issue, class Consume>
__device__ __forceinline__ void sweep(S* ring, Next next, Issue issue, Consume consume) {
  int issued = 0;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    const auto t = next();
    if (live(t)) issue(ring[issued++ & (kStages - 1)], t);
    cp_async_commit();
  }
  for (int done = 0; done < issued; ++done) {
    const auto t = next();
    if (live(t)) issue(ring[issued++ & (kStages - 1)], t);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    consume(ring[done & (kStages - 1)]);
    __syncwarp();  // the stage is refilled next
  }
}

// (da, ia) before (db, ib) in the lists' order: by d2, then by index
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// (d, j) into a list sorted by (d2, index) (the caller has checked that it
// comes before the last entry): it goes after every entry before it, and
// the entries after it move down one slot. Each slot reads the old values of
// itself and its predecessor, so the slots are written from the last to the
// first.
template <int N>
__device__ __forceinline__ void insert(float (&dist)[N], int (&idx)[N], float d, int j) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    const bool shift = before(d, j, dist[i - 1], idx[i - 1]);
    const bool here = !shift && before(d, j, dist[i], idx[i]);
    dist[i] = shift ? dist[i - 1] : (here ? d : dist[i]);
    idx[i] = shift ? idx[i - 1] : (here ? j : idx[i]);
  }
  if (before(d, j, dist[0], idx[0])) {
    dist[0] = d;
    idx[0] = j;
  }
}

}  // namespace
