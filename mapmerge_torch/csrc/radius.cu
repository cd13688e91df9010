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
// (0.8 and 0.6 m at 0.1 m voxels) under 2% of the pairs are members. The
// design is kernel C's (sift.cu):
// 1. Exact culling by tile boxes, over tiles.cu's pre-pass (mm_tiles_pack of
//    the points and their mask, one a call): a warp tests 32 tiles at once,
//    one a lane, against the box of its queries, then each tile that passes
//    against each query; a tile that none of them reaches is never loaded.
//    The clouds come out of the voxel grid in voxel order, so a tile is a
//    compact box; on any other order the culling stays exact and only stops
//    paying. A warp of queries parked at FAR scans the boxes and loads no
//    tile.
// 2. cull.cuh's cp.async ring brings in the tiles that survive while the
//    warp works on the one before.
// 3. kLanes lanes share a query, lane g of them the points j = g (mod
//    kLanes) of each tile, all tested at once with no branch. E's lanes add
//    their counts (integers: exact in any order). F's lanes each sum their
//    members in tile order, and the kLanes partial sums are added in a fixed
//    tree, so a run repeats bit for bit and F's bits do not depend on the
//    card.
// The queries may be any points, not only the cloud's own.
// No FMA contraction (-fmad=false), no atomics, no fast-math.

#include "cull.cuh"

namespace {

constexpr int kLanes = 8;              // lanes that share a query
constexpr int kPerWarp = 32 / kLanes;  // queries a warp
constexpr int kMine = kT / kLanes;     // points of a tile a lane tests

// The query's members, tile by tile, for the calling lane: take(stage, in)
// gets each tile the warp visits and the bits i of the lane's points
// st.pt[g + i * kLanes] that are members. The warp's queries go through
// `table` (shared memory); an idle lane's query is NaN, within r2 of no
// point. A warp with no query (warp-uniform) visits nothing.
template <class Take>
__device__ __forceinline__ void members(Stage* ring, float4* table,
                                        const float4* __restrict__ pts,
                                        const float4* __restrict__ boxes, int ntiles,
                                        bool active, float qx, float qy, float qz,
                                        float r2, int lane, Take take) {
  const int slot = lane / kLanes, g = lane % kLanes;
  const Box qb = warp_box(active, qx, qy, qz);
  if (!(qb.lx <= qb.hx)) return;
  if (g == 0) table[slot] = make_float4(qx, qy, qz, active ? 1.f : 0.f);
  __syncwarp();

  // a chunk of 32 tiles, one a lane: the box test against the warp's query
  // box, then, where it passes, the lane's tile against each query
  int pos = 0, base = 0;
  unsigned keep = 0;
  auto next = [&]() -> int {
    while (keep == 0) {
      if (pos >= ntiles) return -1;
      const int t = pos + lane;
      bool reach = false;
      if (t < ntiles) {
        const float4 lo = boxes[2LL * t], hi = boxes[2LL * t + 1];
        if (boxes_bound(qb, lo, hi) <= r2) {
          for (int k = 0; k < kPerWarp && !reach; ++k) {
            const float4 e = table[k];
            reach = e.w != 0.f && box_bound(e.x, e.y, e.z, lo, hi) <= r2;
          }
        }
      }
      keep = __ballot_sync(kAll, reach);
      base = pos;
      pos += 32;
    }
    const int b = __ffs(static_cast<int>(keep)) - 1;
    keep &= keep - 1;
    return base + b;
  };
  sweep(ring, next, [&](Stage& st, int t) { issue(st, pts, boxes, t, lane); },
        [&](const Stage& st) {
    unsigned in = 0;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const float4 t = st.pt[g + i * kLanes];
      // false for NaN: a masked point, a row past P, or an idle lane
      in |= static_cast<unsigned>(sq_dist(qx, qy, qz, t.x, t.y, t.z) <= r2) << i;
    }
    take(st, in);
  });
}

// ---- kernel E ----

__global__ void __launch_bounds__(kThreads)
count_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
             int ntiles, const float* __restrict__ q, int nq, float r2,
             int* __restrict__ out) {
  __shared__ Stage ring[kWarps][kStages];
  __shared__ float4 queries[kWarps][kPerWarp];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qi =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPerWarp + lane / kLanes;
  const bool active = qi < nq;
  const float nan = __int_as_float(0x7fc00000);
  const float qx = active ? q[3 * qi] : nan;
  const float qy = active ? q[3 * qi + 1] : nan;
  const float qz = active ? q[3 * qi + 2] : nan;
  int n = 0;
  members(ring[warp], queries[warp], pts, boxes, ntiles, active, qx, qy, qz, r2, lane,
          [&](const Stage&, unsigned in) { n += __popc(in); });
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) n += __shfl_xor_sync(kAll, n, o);
  if (active && lane % kLanes == 0) out[qi] = n;
}

// ---- kernel F ----

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
               int ntiles, const float* __restrict__ q, int nq, float r2,
               float* __restrict__ count, float* __restrict__ mean,
               float* __restrict__ cov) {
  __shared__ Stage ring[kWarps][kStages];
  __shared__ float4 queries[kWarps][kPerWarp];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % kLanes;
  const long long qi =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPerWarp + lane / kLanes;
  const bool active = qi < nq;
  const float nan = __int_as_float(0x7fc00000);
  const float qx = active ? q[3 * qi] : nan;
  const float qy = active ? q[3 * qi + 1] : nan;
  const float qz = active ? q[3 * qi + 2] : nan;
  // s1 (x, y, z), then s2 (xx, xy, xz, yy, yz, zz)
  float s[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s[k] = 0.f;
  int n = 0;
  members(ring[warp], queries[warp], pts, boxes, ntiles, active, qx, qy, qz, r2, lane,
          [&](const Stage& st, unsigned in) {
            n += __popc(in);
            while (in != 0) {  // this lane's members, in index order
              const int i = __ffs(static_cast<int>(in)) - 1;
              in &= in - 1;
              const float4 t = st.pt[g + i * kLanes];
              s[0] = __fadd_rn(s[0], t.x);
              s[1] = __fadd_rn(s[1], t.y);
              s[2] = __fadd_rn(s[2], t.z);
              s[3] = __fadd_rn(s[3], __fmul_rn(t.x, t.x));
              s[4] = __fadd_rn(s[4], __fmul_rn(t.x, t.y));
              s[5] = __fadd_rn(s[5], __fmul_rn(t.x, t.z));
              s[6] = __fadd_rn(s[6], __fmul_rn(t.y, t.y));
              s[7] = __fadd_rn(s[7], __fmul_rn(t.y, t.z));
              s[8] = __fadd_rn(s[8], __fmul_rn(t.z, t.z));
            }
          });
  // the kLanes partial sums, in a tree every lane of the query computes
  // alike (a + b and b + a round alike)
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    n += __shfl_xor_sync(kAll, n, o);
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = __fadd_rn(s[k], __shfl_xor_sync(kAll, s[k], o));
  }
  if (!active || g != 0) return;
  const float s0 = static_cast<float>(n);  // exact below 2^24
  const float denom = fmaxf(s0, 1.f);
  const float m[3] = {__fdiv_rn(s[0], denom), __fdiv_rn(s[1], denom),
                      __fdiv_rn(s[2], denom)};
  // s2's slot of entry (i, j) of the 3 x 3 matrix
  constexpr int kSlot[3][3] = {{3, 4, 5}, {4, 6, 7}, {5, 7, 8}};
  count[qi] = s0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mean[3 * qi + i] = m[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cov[9 * qi + 3 * i + j] =
          __fsub_rn(__fdiv_rn(s[kSlot[i][j]], denom), __fmul_rn(m[i], m[j]));
    }
  }
}

unsigned blocks_for(int nq) {
  constexpr int per_block = kPerWarp * kWarps;
  return static_cast<unsigned>((nq + per_block - 1) / per_block);
}

}  // namespace

// pts, boxes from mm_tiles_pack of the np centred points and their mask; q
// (nq, 3) f32 centred alike; out (nq,) i32, the members of each query.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_radius_count(const float* pts, const float* boxes, int np,
                               const float* q, int nq, float r2, int* out,
                               void* stream) {
  if (nq < 1 || np < 1) return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<blocks_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), reinterpret_cast<const float4*>(boxes),
      (np + kT - 1) / kT, q, nq, r2, out);
  return static_cast<int>(cudaGetLastError());
}

// pts, boxes from mm_tiles_pack of the np centred points and their mask; q
// (nq, 3) f32 centred alike; count (nq,), mean (nq, 3) and cov (nq, 3, 3)
// f32, in the centred frame. Returns cudaGetLastError() after the launch.
extern "C" int mm_radius_moments(const float* pts, const float* boxes, int np,
                                 const float* q, int nq, float r2, float* count,
                                 float* mean, float* cov, void* stream) {
  if (nq < 1 || np < 1) return static_cast<int>(cudaErrorInvalidValue);
  moments_kernel<<<blocks_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), reinterpret_cast<const float4*>(boxes),
      (np + kT - 1) / kT, q, nq, r2, count, mean, cov);
  return static_cast<int>(cudaGetLastError());
}
