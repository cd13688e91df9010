// SIFT's dense octave for Hopper (sm_90a): the Gaussian scale space (kernel
// C) and the 26 nearest neighbours of the extremum test (kernel D), over the
// tile pre-pass of tiles.cu.
//
// Neither C nor D replaces a Pallas kernel: the JAX package leaves both to
// XLA. Kernel C replaces the dense branch of mapmerge_tpu/ops/keypoints/
// sift.py `_scale_space`; kernel D the dense `radius_neighbors` (mapmerge_tpu/
// ops/neighbors.py) that sift.py calls for the 26-NN. Their plain PyTorch
// versions are kernels/sift.py: scale_space_ref and knn_ref.
//
// What they compute.
// Kernel C (mm_sift_scale_space): for each query and each of the S sigmas,
// num / max(den, 1e-12) with num = sum w * val and den = sum w over the
// valid points within r2_bound of the query, w = exp(-d2 / (2 s^2)). d2 is
// the direct expansion of ops/neighbors.sq_dists, ((dx^2 + dy^2) + dz^2) on
// centred float32 coordinates, through __fsub_rn / __fmul_rn / __fadd_rn,
// so it is sq_dists' value bit for bit and the bound test takes the same
// points as the plain version. The exponent is -d2 times the float32
// reciprocal of 2 s^2 (the product PyTorch's division by a scalar makes on
// the card), then expf; num and den are summed in point order in G parts
// and the parts added in a fixed tree (design 3), so a run repeats bit for
// bit. The plain version's matrix-vector product sums in another order, so
// the two agree to rounding (kernels/sift.py states the tolerance).
// Kernel D (mm_sift_knn): for each query the k <= 26 smallest (d2, index)
// pairs in lexicographic order, nearest first, with masked targets at d2 =
// BIG (1e12) as in ops/neighbors.radius_neighbors; valid = d2 <= r2. Ties go
// to the lower index, as lax.top_k's order and the plain version's stable
// sort have it. Each lane keeps its query's list sorted by (d2, index) in
// registers, and a candidate enters when it comes before the 26th in that
// order, so the list does not depend on the order in which points arrive.
//
// What bounds them. Swept densely, FP32 issue on the CUDA cores: every
// (query, point) pair costs the distance (3 subtractions, 3 products, 2
// sums) and a compare, though under 1% of the pairs lie within C's bound at
// config #1's octave 0, and D keeps 26 of P. Tensor cores do not serve: the
// bound test and the neighbour order need sq_dists' exact direct-expansion
// bits, and a TF32 or bf16 product of the matmul expansion would move
// points across r2_bound and reorder near-ties.
//
// What the design does about it.
// 1. Exact culling by tile boxes. The pre-pass (tiles.cu) writes the
//    points once as float4 (x, y, z, value), x = NaN for a masked point (it
//    fails C's bound test, and D reads it as masked), and for each tile of
//    kT = 32 consecutive points the box of its valid points (lo, hi), the
//    first masked index of the tile (lo.w, as int bits; INT_MAX if none) and
//    the tile's first point index (hi.w). SIFT packs each dense octave once
//    and hands the buffer to both kernels (D ignores w). Octaves come out of
//    the voxel grid in lexicographic key order, so a tile is a compact box in
//    space. For a query q the box bound clamps q into the box and takes
//    sq_dist to that point with the same rounded operations: rounding is
//    monotone, so the bound is <= the kernel's own d2 for every point of the
//    box, with no epsilon, and a tile whose bound exceeds the threshold of
//    every query of a warp holds no point that any of them takes. A warp
//    tests 32 tiles at once, one a lane: against the box of its queries (a
//    bound below every query's own), then, where that passes, against each
//    query (kept in shared memory). C's threshold is r2_bound; D's is each
//    query's current bound on its 26th (kernel D below), compared as (d2,
//    index), and a tile that holds a masked point counts at (BIG, its first
//    masked index). On clouds that are not in voxel order culling stays exact
//    and only stops paying.
// 2. An asynchronous tile ring. Each warp works on its own queries with its
//    own ring of kStages shared-memory stages: the surviving tiles come in by
//    cp.async (16 bytes a lane) while the warp computes on the one before,
//    and the scan for the next surviving tile runs while copies are in
//    flight. A stage also carries the tile's box, so D checks a tile again
//    against its bounds as they are when it arrives.
// 3. Latency, not issue, bounds a warp once culling has removed most of the
//    work: its tiles, and within them its points within the bound (C) or its
//    candidates (D), are a dependent chain. So G lanes share a query, lane g
//    of them the points j = g (mod G) of each tile (C: G = 8 always; D: 1, 2
//    or 4, chosen from Q alone, kernels/sift.py): the chain of each lane is 1
//    / G as long, and a small octave fills the card. Each lane first tests
//    all its points of a tile at once, with no branch, then works only on
//    those that pass, in index order: the branch of one lane no longer stalls
//    a warp point by point. C's reciprocals of 2 s^2 come by value (no copy
//    to the card, no division in the loop), and its 8 partial sums are added
//    in a fixed tree, so C's bits do not depend on the card. D's lanes keep a
//    list each; a query's bound is the largest of its lanes' ceil(26 / G)-th
//    entries (their first entries hold 26 points no later than it), and the
//    lists are merged at the end.
// 4. D visits its warp's own tile and the two beside it first (the queries
//    are the points in SIFT, so in voxel order these are their
//    neighbourhood), together, so its bounds are finite and near before the
//    first scan; then every other tile in index order. A query parked at
//    FAR (1e8) finds its masked targets in the first tiles that hold them.
// No splits and no second pass: a warp sweeps every surviving tile itself.
// No FMA contraction (-fmad=false), no atomics, no fast-math.
// The tile, its box bounds and the ring (points 1-2) are cull.cuh's, shared
// with the radius sweeps of radius.cu (kernels E and F).

#include "cull.cuh"

namespace {

constexpr int kSigLane = 8;    // sigmas a lane of kernel C holds
constexpr int kCLanes = 8;     // lanes of kernel C that share a query
constexpr int kMaxSigma = 64;  // sigmas a launch of kernel C takes
constexpr int kK = 26;         // list length: the 25-NN plus the point itself
constexpr float kBig = 1.0e12f;

struct Recips {
  float v[kMaxSigma];
};

// ---- kernel C ----

// kCLanes lanes share a query, lane g of them the points j = g (mod
// kCLanes) of each tile, with all the sigmas of the launch's group
// (blockIdx.y) in registers; their sums are added at the end in a fixed tree
// order.
__global__ void __launch_bounds__(kThreads)
scale_space_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
                   int ntiles, const float* __restrict__ q, int nq,
                   const Recips recips, int n_sigma, float r2_bound,
                   float* __restrict__ out) {
  constexpr int G = kCLanes, kPerWarp = 32 / G, kMine = kT / G;
  __shared__ Stage ring[kWarps][kStages];
  __shared__ float4 queries[kWarps][kPerWarp];  // the warp's queries; w = 1 if active
  __shared__ float recip_sh[kMaxSigma];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kMaxSigma; ++s) recip_sh[s] = recips.v[s];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / G, g = lane % G;
  const long long qi =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPerWarp + slot;
  const bool active = qi < nq;
  const float nan = __int_as_float(0x7fc00000);
  const float qx = active ? q[3 * qi] : nan;  // NaN: nothing is within the bound
  const float qy = active ? q[3 * qi + 1] : nan;
  const float qz = active ? q[3 * qi + 2] : nan;
  const int s0 = blockIdx.y * kSigLane;
  const int mine = min(kSigLane, n_sigma - s0);
  float recip[kSigLane], num[kSigLane], den[kSigLane];
#pragma unroll
  for (int i = 0; i < kSigLane; ++i) {
    recip[i] = i < mine ? recip_sh[s0 + i] : 0.f;
    num[i] = den[i] = 0.f;
  }
  const Box qb = warp_box(active, qx, qy, qz);
  if (!(qb.lx <= qb.hx)) return;  // no query in this warp
  float4* const table = queries[warp];
  if (g == 0) table[slot] = make_float4(qx, qy, qz, active ? 1.f : 0.f);
  __syncwarp();

  // tiles in index order, so each lane sums its points in index order. A
  // chunk of 32 tiles, one a lane: the box test against the warp's query
  // box, then, where it passes, the lane's tile against each query.
  int pos = 0, base = 0;
  unsigned keep = 0;
  auto next = [&]() -> int {
    while (keep == 0) {
      if (pos >= ntiles) return -1;
      const int t = pos + lane;
      bool reach = false;
      if (t < ntiles) {
        const float4 lo = boxes[2LL * t], hi = boxes[2LL * t + 1];
        if (boxes_bound(qb, lo, hi) <= r2_bound) {
          for (int k = 0; k < kPerWarp && !reach; ++k) {
            const float4 e = table[k];
            reach = e.w != 0.f && box_bound(e.x, e.y, e.z, lo, hi) <= r2_bound;
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
  // this lane's points within the bound first, all at once (no branch),
  // then each of them in index order
  auto consume = [&](const Stage& st) {
    unsigned in = 0;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const float4 t = st.pt[g + i * G];
      // false for NaN: a masked point, or an idle lane
      in |= static_cast<unsigned>(sq_dist(qx, qy, qz, t.x, t.y, t.z) <= r2_bound) << i;
    }
    while (in != 0) {
      const int i = __ffs(static_cast<int>(in)) - 1;
      in &= in - 1;
      const float4 t = st.pt[g + i * G];
      const float neg = -sq_dist(qx, qy, qz, t.x, t.y, t.z);
#pragma unroll
      for (int s = 0; s < kSigLane; ++s) {
        if (s < mine) {
          const float w = expf(__fmul_rn(neg, recip[s]));
          num[s] = __fadd_rn(num[s], __fmul_rn(w, t.w));
          den[s] = __fadd_rn(den[s], w);
        }
      }
    }
  };
  sweep(ring[warp], next,
        [&](Stage& st, int t) { issue(st, pts, boxes, t, lane); }, consume);
  // the G partial sums, in a tree every lane of the query computes alike
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
#pragma unroll
    for (int s = 0; s < kSigLane; ++s) {
      num[s] = __fadd_rn(num[s], __shfl_xor_sync(kAll, num[s], o));
      den[s] = __fadd_rn(den[s], __shfl_xor_sync(kAll, den[s], o));
    }
  }
  if (!active || g != 0) return;
#pragma unroll
  for (int s = 0; s < kSigLane; ++s) {
    if (s < mine) {
      out[static_cast<long long>(s0 + s) * nq + qi] =
          __fdiv_rn(num[s], fmaxf(den[s], 1e-12f));
    }
  }
}

// ---- kernel D ----

// cull.cuh's before() and insert() keep the lists: by d2, then by index

// whether a point of the tile [lo, hi] may come before (d26, i26): a valid
// one within the box bound, or its first masked one at BIG
__device__ __forceinline__ bool reaches(float qx, float qy, float qz, float4 lo,
                                        float4 hi, float d26, int i26) {
  const int first_masked = __float_as_int(lo.w);
  return box_bound(qx, qy, qz, lo, hi) <= d26 ||
         (first_masked != INT_MAX && before(kBig, first_masked, d26, i26));
}

// G lanes share a query, lane g of them the points j = g (mod G) of each
// tile, each with its own list; the query's bound is the largest, in the
// lists' order, of their ceil(26 / G)-th entries: the union of the G lists'
// first ceil(26 / G) entries holds 26 points no later than it, so no point
// after it is among the query's 26 (for G = 1, the 26th itself). At the end
// the G lists are merged, every lane of the query alike.
template <int G>
__device__ __forceinline__ void group_bound(const float (&dist)[kK], const int (&idx)[kK],
                                            float& d, int& i) {
  constexpr int m = (kK + G - 1) / G;
  d = dist[m - 1];
  i = idx[m - 1];
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float od = __shfl_xor_sync(kAll, d, o);
    const int oi = __shfl_xor_sync(kAll, i, o);
    if (before(d, i, od, oi)) {
      d = od;
      i = oi;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
           int ntiles, const float* __restrict__ q, int nq, int np, int k, float r2,
           int* __restrict__ idx_out, unsigned char* __restrict__ valid_out) {
  constexpr int kPerWarp = 32 / G, kMine = kT / G;
  __shared__ Stage ring[kWarps][kStages];
  __shared__ float4 queries[kWarps][kPerWarp];  // the queries, w: their bound's d2
  __shared__ int bound_idx[kWarps][kPerWarp];   // and its index
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / G, g = lane % G;
  const long long q0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPerWarp;
  if (q0 >= nq) return;  // the whole warp
  const long long qi = q0 + slot;
  const bool active = qi < nq;
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  const float qx = active ? q[3 * qi] : nan;
  const float qy = active ? q[3 * qi + 1] : nan;
  const float qz = active ? q[3 * qi + 2] : nan;
  float dist[kK];
  int idx[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    dist[i] = inf;  // filled by the first kK
    idx[i] = INT_MAX;
  }
  const Box qb = warp_box(active, qx, qy, qz);
  Stage* const my = ring[warp];
  float4* const table = queries[warp];
  int* const table_idx = bound_idx[warp];

  // this lane's candidates all at once against the query's bound as it is
  // (no branch; the bound only falls, so no point that enters is missed),
  // then each of them in index order against the lane's list as it is then
  auto consume = [&](const Stage& st) {
    const int t0 = __float_as_int(st.hi.w);
    const int n = min(kT, np - t0);
    float bd;
    int bi;
    group_bound<G>(dist, idx, bd, bi);
    unsigned cand = 0;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int j = g + i * G;
      const float4 t = st.pt[j];
      const float d2 = isnan(t.x) ? kBig : sq_dist(qx, qy, qz, t.x, t.y, t.z);
      cand |= static_cast<unsigned>(j < n && before(d2, t0 + j, bd, bi)) << i;
    }
    while (cand != 0) {
      const int i = __ffs(static_cast<int>(cand)) - 1;
      cand &= cand - 1;
      const int j = g + i * G;
      const float4 t = st.pt[j];
      // a masked target: BIG
      const float d2 = isnan(t.x) ? kBig : sq_dist(qx, qy, qz, t.x, t.y, t.z);
      if (before(d2, t0 + j, dist[kK - 1], idx[kK - 1])) insert(dist, idx, d2, t0 + j);
    }
  };

  // first the warp's own tile and its two neighbours in index order (where
  // its queries lie among the points when the queries are the points, as in
  // SIFT: in voxel order, their neighbourhood), together and at once, so
  // the lists hold near points before the first scan
  const int own = static_cast<int>(
      min(static_cast<long long>(ntiles - 1), q0 * np / nq / kT));
  const int w_lo = max(0, own - 1), w_hi = min(ntiles - 1, own + 1);
  for (int t = w_lo; t <= w_hi; ++t) issue(my[t - w_lo], pts, boxes, t, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  consume(my[own - w_lo]);
  for (int t = w_lo; t <= w_hi; ++t) {
    if (t != own) consume(my[t - w_lo]);
  }
  __syncwarp();

  // then every other tile in index order: position p is tile p below the
  // window, p + its width above it. A chunk of 32 tiles, one a lane: the
  // box test against the warp's query box and loosest bound, then, where it
  // passes, the lane's tile against each query's bound
  const int width = w_hi - w_lo + 1;
  int pos = 0;
  unsigned keep = 0;
  int chunk_tile = 0;  // this lane's tile of the scanned chunk
  auto next = [&]() -> int {
    while (keep == 0) {
      if (pos >= ntiles - width) return -1;
      float bd;
      int bi;
      group_bound<G>(dist, idx, bd, bi);
      if (g == 0) {
        table[slot] = make_float4(qx, qy, qz, active ? bd : -inf);
        table_idx[slot] = bi;
      }
      float worst = active ? bd : -inf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        worst = fmaxf(worst, __shfl_xor_sync(kAll, worst, o));
      }
      __syncwarp();
      const int p = pos + lane;
      chunk_tile = p < w_lo ? p : p + width;
      bool reach = false;
      if (p < ntiles - width) {
        const float4 lo = boxes[2LL * chunk_tile], hi = boxes[2LL * chunk_tile + 1];
        if (boxes_bound(qb, lo, hi) <= worst ||
            (__float_as_int(lo.w) != INT_MAX && kBig <= worst)) {
          for (int j = 0; j < kPerWarp && !reach; ++j) {
            const float4 e = table[j];
            reach = reaches(e.x, e.y, e.z, lo, hi, e.w, table_idx[j]);
          }
        }
      }
      keep = __ballot_sync(kAll, reach);
      pos += 32;
      __syncwarp();  // the table is written again at the next scan
    }
    const int b = __ffs(static_cast<int>(keep)) - 1;
    keep &= keep - 1;
    return __shfl_sync(kAll, chunk_tile, b);
  };
  sweep(my, next, [&](Stage& st, int t) { issue(st, pts, boxes, t, lane); },
        [&](const Stage& st) {
    // again, against the bounds as they are when the tile arrives
    float bd;
    int bi;
    group_bound<G>(dist, idx, bd, bi);
    if (__any_sync(kAll, active && reaches(qx, qy, qz, st.lo, st.hi, bd, bi))) {
      consume(st);
    }
  });

  // the G lists of a query merged in a tree, a partner's list (as it was
  // before this round, through shared memory) into each lane's: lists of
  // disjoint points, so each round leaves both partners the first 26 of
  // their union, and the last round every lane of the query its 26
  if constexpr (G > 1) {
    __shared__ int2 exchange[kWarps][kK][32];
    int2 (&x)[kK][32] = exchange[warp];
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kK; ++i) x[i][lane] = make_int2(__float_as_int(dist[i]), idx[i]);
      __syncwarp();
      for (int i = 0; i < kK; ++i) {
        const int2 e = x[i][lane ^ o];
        const float d = __int_as_float(e.x);
        if (!before(d, e.y, dist[kK - 1], idx[kK - 1])) break;  // and all after it
        insert(dist, idx, d, e.y);
      }
      __syncwarp();
    }
  }
  if (!active || g != 0) return;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    if (i < k) {
      idx_out[qi * k + i] = idx[i];
      valid_out[qi * k + i] = dist[i] <= r2;
    }
  }
}

}  // namespace

// pts, boxes from mm_tiles_pack of the np centred points (values in w); q
// (nq, 3) f32 centred alike; recips (n_sigma <= 64,) f32 in host memory,
// the reciprocals of 2 s^2, passed by value; out (n_sigma, nq) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_sift_scale_space(const float* pts, const float* boxes, int np,
                                   const float* q, int nq, const float* recips,
                                   int n_sigma, float r2_bound, float* out,
                                   void* stream) {
  if (n_sigma < 1 || n_sigma > kMaxSigma || nq < 1 || np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Recips r{};
  for (int s = 0; s < n_sigma; ++s) r.v[s] = recips[s];
  const long long per_block = 32LL / kCLanes * kWarps;
  const dim3 grid(static_cast<unsigned>((nq + per_block - 1) / per_block),
                  (n_sigma + kSigLane - 1) / kSigLane);
  scale_space_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), reinterpret_cast<const float4*>(boxes),
      (np + kT - 1) / kT, q, nq, r, n_sigma, r2_bound, out);
  return static_cast<int>(cudaGetLastError());
}

// pts, boxes from mm_tiles_pack of the np centred targets and their mask; q
// (nq, 3) f32 centred alike; 1 <= k <= min(26, np); lanes_per_query 1, 2
// or 4; idx_out (nq, k) i32, valid_out (nq, k) bool. Returns
// cudaGetLastError() after the launch.
extern "C" int mm_sift_knn(const float* pts, const float* boxes, int np,
                           const float* q, int nq, int k, float r2,
                           int lanes_per_query, int* idx_out,
                           unsigned char* valid_out, void* stream) {
  const int g = lanes_per_query;
  if (k < 1 || k > kK || k > np || nq < 1 || (g != 1 && g != 2 && g != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = 32LL / g * kWarps;
  const unsigned blocks = static_cast<unsigned>((nq + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p4 = reinterpret_cast<const float4*>(pts);
  const auto* b4 = reinterpret_cast<const float4*>(boxes);
  const int ntiles = (np + kT - 1) / kT;
  switch (g) {
    case 1:
      knn_kernel<1><<<blocks, kThreads, 0, st>>>(p4, b4, ntiles, q, nq, np, k, r2, idx_out,
                                                  valid_out);
      break;
    case 2:
      knn_kernel<2><<<blocks, kThreads, 0, st>>>(p4, b4, ntiles, q, nq, np, k, r2, idx_out,
                                                  valid_out);
      break;
    default:
      knn_kernel<4><<<blocks, kThreads, 0, st>>>(p4, b4, ntiles, q, nq, np, k, r2, idx_out,
                                                  valid_out);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
