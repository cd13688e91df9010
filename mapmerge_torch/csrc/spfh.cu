// SPFH sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mapmerge_tpu/pallas/spfh.py
// (spfh_tile_pallas / _spfh_kernel): for each oriented query point, the
// Darboux pair features (pcl::computePairFeatures, with its role swap and the
// exclusion of coincident points and degenerate frames) against every
// candidate with eps < d^2 <= r^2 and ok set; theta, alpha and phi go into 11
// bins each, plus a pair count, and each histogram row is scaled to sum 100.
// The math is that of the plain/XLA path (mapmerge_tpu/ops/descriptors/
// fpfh.py:_spfh_dense, ops/descriptors/darboux.py): theta comes from atan2f
// and the floor-and-clip bin_index, not from the sector tests that the TPU
// kernel uses for lack of an atan2.
//
// What bounds it on the card: FP32 arithmetic and the special-function
// units, on the pairs that lie within the radius. A counted pair costs ~78
// FP32 operations, two square roots, six divisions and one atan2; config #1
// counts ~3.1e6 such pairs per cloud (~270 per query that counts any), out of
// 8.1e8 (query, candidate) pairs. Bytes are a few MB.
//
// Shared mode (one candidate cloud for every query), mm_spfh_shared:
//   - bin_count_kernel, bin_scan_kernel and bin_scatter_kernel gather the ok
//     candidates by the hash bucket of their cell (edge r (1 + 1e-3), so
//     rounding in x / cell never puts an in-radius pair two cells apart)
//     and give each bucket's range; a collision only adds candidates that
//     fail the radius test;
//   - spfh_shared_kernel:
//     one block takes a group of queries that lie close together (the rows
//     of one keypoint: its neighbours, all within r of it). It collects the
//     distinct buckets of the 27 cells around each of its queries, stages
//     those buckets' candidates through shared memory once, and every query
//     of the block tests them. The cheap distance test runs over (query,
//     candidate) pairs, a warp's lanes over consecutive candidates; hits go
//     into the warp's queue in shared memory (__ballot_sync), and the
//     Darboux features run over the queue 32 at a time with every lane busy;
//   - counts, in the binning and the histograms, are integer atomicAdds:
//     integer sums are exact in any order, so the result repeats bit for
//     bit whatever order the atomics take.
// Grid mode (the grid engine's SPFH sweep, ops/descriptors/fpfh.py:
// _spfh_grid: the needed points of one cloud against the cloud's cell grid,
// ops/grid.py:build_grid), mm_spfh_grid, one launch per cloud:
//   - spfh_grid_kernel: one block per (bucket that holds a needed slot,
//     group of up to 32 of its needed slots; a bucket holds ~17 of them on
//     config #2, so most buckets take one block). It reads the grid in place:
//     the query slots' coordinates from the (H, C, 3) cells, their normals
//     through the slots' point indices from the (P, 3) normals, and the
//     filled slots [0, count) of the distinct wrapped neighbour buckets of
//     its bucket (ids repeated by wrapping on tiny grids are taken once, as
//     ops/grid.py:_candidates masks them). Slots that are not needed are
//     never swept;
//   - the candidates go through shared memory in rounds and the sweep is the
//     shared kernel's (stage_index, sweep_stage, write_rows below): the
//     distance pre-test without a square root, the per-warp queue of hits,
//     every lane busy in the Darboux features, integer shared atomics, one
//     scale pass. Rows go to the slots' point indices, each written once.
//   What bounds it: a config #2 cloud counts ~8.5e6 pairs for ~30,000
//   needed slots, ~0.01 ms of FP32 work at the card's peak, less than the
//   time to write the (P, 33) output that the wrapper zero-fills (143 MB
//   at P = 2^20). A block stages ~1,200 candidates, each through two
//   dependent loads (the slot's point index, then its normal).
//
// The library is built with -fmad=false, and every pair goes through
// pair_bins below in the order of the plain PyTorch version (kernels/spfh.py:
// spfh_ref) with IEEE sqrtf, '/' and atan2f, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 11;
constexpr int kHist = 3 * kBins + 1;  // 33 bins + pair count
constexpr float kEps = 1.0e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// shared and grid mode
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 64;                  // queries per block
constexpr int kMaxBuckets = kGroupMax * 27;    // distinct buckets per block
constexpr int kStage = 512;                    // candidates staged per round
constexpr int kQueue = 64;                     // hits queued per warp
constexpr int kTable = 1 << 15;                // buckets; kernels/spfh.py: _TABLE
constexpr float kCellClamp = 1073741824.f;     // 2^30
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kNeighbors = 27;                 // grid mode: buckets per block
constexpr int kGridGroup = 32;                 // grid mode: queries per block

__device__ __forceinline__ int bin_index(float value, float lo, float span) {
  // floor((value - lo) / span * bins), clipped (darboux.bin_index)
  const int i = static_cast<int>(floorf((value - lo) / span * kBins));
  return min(max(i, 0), kBins - 1);
}

// The three bins of the pair (query p1, n1; candidate p2, n2), in the order
// of spfh_ref; false where the pair does not count (coincident points,
// outside r2, degenerate frame).
__device__ __forceinline__ bool pair_bins(
    float px, float py, float pz, float n1x, float n1y, float n1z, float cx,
    float cy, float cz, float n2x, float n2y, float n2z, float r2, int* bt,
    int* ba, int* bp) {
  // d = p2 - p1 (candidate - query)
  const float dx = cx - px;
  const float dy = cy - py;
  const float dz = cz - pz;
  const float dist2 = dx * dx + dy * dy + dz * dz;
  if (!(dist2 > kEps)) return false;  // coincident points
  const float dist = sqrtf(fmaxf(dist2, kEps));
  if (!(dist * dist <= r2)) return false;
  const float dhx = dx / dist, dhy = dy / dist, dhz = dz / dist;

  // role swap: the source is the point whose normal is better aligned
  // with the connecting line
  const float cos1 = n1x * dhx + n1y * dhy + n1z * dhz;
  const float cos2 = n2x * -dhx + n2y * -dhy + n2z * -dhz;
  const bool swap = fabsf(cos1) < fabsf(cos2);
  const float usx = swap ? n2x : n1x, usy = swap ? n2y : n1y,
              usz = swap ? n2z : n1z;
  const float ntx = swap ? n1x : n2x, nty = swap ? n1y : n2y,
              ntz = swap ? n1z : n2z;
  const float dsx = swap ? -dhx : dhx, dsy = swap ? -dhy : dhy,
              dsz = swap ? -dhz : dhz;
  const float phi = swap ? cos2 : cos1;

  // Darboux frame: u = ns, v = normalize(ds x u), w = u x v
  float vx = dsy * usz - dsz * usy;
  float vy = dsz * usx - dsx * usz;
  float vz = dsx * usy - dsy * usx;
  const float vnorm2 = vx * vx + vy * vy + vz * vz;
  if (!(vnorm2 > kEps)) return false;  // degenerate frame
  const float vn = sqrtf(fmaxf(vnorm2, kEps));
  vx = vx / vn;
  vy = vy / vn;
  vz = vz / vn;
  const float wx = usy * vz - usz * vy;
  const float wy = usz * vx - usx * vz;
  const float wz = usx * vy - usy * vx;

  const float alpha = vx * ntx + vy * nty + vz * ntz;
  const float theta = atan2f(wx * ntx + wy * nty + wz * ntz,
                             usx * ntx + usy * nty + usz * ntz);
  *bt = bin_index(theta, -kPi, kTwoPi);
  *ba = kBins + bin_index(alpha, -1.f, 2.f);
  *bp = 2 * kBins + bin_index(phi, -1.f, 2.f);
  return true;
}

// floor(x / cell), clamped to +-2^30 (an IEEE division: no fast math)
__device__ __forceinline__ int cell_of(float x, float cell) {
  return static_cast<int>(
      fminf(fmaxf(floorf(x / cell), -kCellClamp), kCellClamp));
}

// The hash bucket of an integer cell (tests/test_torch_kernels.py mirrors
// cell_of and bucket_of in numpy).
__device__ __forceinline__ int bucket_of(int cx, int cy, int cz) {
  const unsigned int h = static_cast<unsigned int>(cx) * 73856093u ^
                         static_cast<unsigned int>(cy) * 19349663u ^
                         static_cast<unsigned int>(cz) * 83492791u;
  return static_cast<int>(h & (kTable - 1));
}

// Bin every ok candidate: its bucket (kTable where not ok), and the count of
// each bucket.
__global__ void bin_count_kernel(const float* __restrict__ c_xyz,
                                 const unsigned char* __restrict__ c_ok, int m,
                                 float cell, int* __restrict__ cand_bucket,
                                 int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int b = kTable;
  if (c_ok[i]) {
    b = bucket_of(cell_of(c_xyz[3LL * i], cell), cell_of(c_xyz[3LL * i + 1], cell),
                  cell_of(c_xyz[3LL * i + 2], cell));
    atomicAdd(&counts[b], 1);
  }
  cand_bucket[i] = b;
}

// Exclusive scan of the bucket counts into starts (kTable + 1, the last the
// total) and the scatter cursors, in one block: warp w scans buckets
// [w * kWarpSpan, (w + 1) * kWarpSpan) in rows of 32, loads and stores
// coalesced, then the warps' totals are scanned.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(const int* __restrict__ counts, int* __restrict__ starts,
                int* __restrict__ cursor) {
  constexpr int kWarpSpan = kTable / (kScanThreads / 32);
  constexpr int kRows = kWarpSpan / 32;
  __shared__ int warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = warp * kWarpSpan + lane;
  int v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) v[k] = counts[base + 32 * k];
  int carry = 0;  // the warp's buckets before row k
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    int incl = v[k];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    const int row = __shfl_sync(0xffffffffu, incl, 31);
    v[k] = carry + incl - v[k];
    carry += row;
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_total[lane];
    int incl = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    warp_total[lane] = incl - w;  // exclusive
    if (lane == 31) starts[kTable] = incl;
  }
  __syncthreads();
  const int off = warp_total[warp];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    starts[base + 32 * k] = off + v[k];
    cursor[base + 32 * k] = off + v[k];
  }
}

// Each ok candidate to a slot of its bucket's range, as (x, y, z, 0) and
// (nx, ny, nz, 0). The order within a bucket follows the atomics; the sweep's
// integer counts do not depend on it.
__global__ void bin_scatter_kernel(const float* __restrict__ c_xyz,
                                   const float* __restrict__ c_nrm, int m,
                                   const int* __restrict__ cand_bucket,
                                   int* __restrict__ cursor,
                                   float4* __restrict__ s_pos,
                                   float4* __restrict__ s_nrm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m || cand_bucket[i] == kTable) return;
  const int slot = atomicAdd(&cursor[cand_bucket[i]], 1);
  const long long g = 3LL * i;
  s_pos[slot] = make_float4(c_xyz[g], c_xyz[g + 1], c_xyz[g + 2], 0.f);
  s_nrm[slot] = make_float4(c_nrm[g], c_nrm[g + 1], c_nrm[g + 2], 0.f);
}

// Bin one queued (query << 16 | staged candidate) pair into its query's
// shared counters (integer atomics: exact in any order).
__device__ __forceinline__ void bin_queued(
    int e, const float (*qs)[kGroupMax], const float4* pos, const float4* nrm,
    unsigned int (*hist)[kHist], float r2) {
  const int q = e >> 16, j = e & 0xffff;
  const float4 c = pos[j], n = nrm[j];
  int bt, ba, bp;
  if (pair_bins(qs[0][q], qs[1][q], qs[2][q], qs[3][q], qs[4][q], qs[5][q],
                c.x, c.y, c.z, n.x, n.y, n.z, r2, &bt, &ba, &bp)) {
    atomicAdd(&hist[q][bt], 1u);
    atomicAdd(&hist[q][ba], 1u);
    atomicAdd(&hist[q][bp], 1u);
    atomicAdd(&hist[q][3 * kBins], 1u);
  }
}

// The source index of staged candidate i: in the block's list of buckets
// (bpre their candidates scanned, bfirst each one's first candidate), the
// last bucket k with bpre[k] <= i, then the offset into it.
__device__ __forceinline__ int stage_index(int i, const int* bpre,
                                           const int* bfirst, int nb) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bpre[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return bfirst[lo] + (i - bpre[lo]);
}

// Test each of the block's nqb queries against the n staged candidates and
// bin the pairs within the radius. A warp takes a query and sweeps its
// candidates 32 at a time, a lane a candidate; where the block holds fewer
// queries than warps, the warps split each query's candidates. The cheap
// distance test's hits go into the warp's queue (__ballot_sync), and the
// Darboux features run over the queue 32 at a time with every lane busy.
__device__ __forceinline__ void sweep_stage(
    const float (*qs)[kGroupMax], int nqb, const float4* pos,
    const float4* nrm, int n, int (*queue)[kQueue],
    unsigned int (*hist)[kHist], float r2, float r2_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = max(1, kWarps / nqb);  // warps per query
  int queued = 0;                          // warp-uniform
  for (int q = warp / split; q < nqb; q += kWarps / split) {
    const float px = qs[0][q], py = qs[1][q], pz = qs[2][q];
    for (int j0 = (warp % split) * 32; j0 < n; j0 += split * 32) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < n) {
        // the distance of pair_bins; r2_hi lets through every pair whose
        // rounded sqrt passes r2 there
        const float4 c = pos[j];
        const float dx = c.x - px;
        const float dy = c.y - py;
        const float dz = c.z - pz;
        const float dist2 = dx * dx + dy * dy + dz * dz;
        hit = dist2 > kEps && dist2 <= r2_hi;
      }
      const unsigned int hits = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        queue[warp][queued + __popc(hits & ((1u << lane) - 1u))] = (q << 16) | j;
      }
      queued += __popc(hits);
      if (queued >= 32) {
        __syncwarp();
        bin_queued(queue[warp][lane], qs, pos, nrm, hist, r2);
        __syncwarp();
        if (lane < queued - 32) queue[warp][lane] = queue[warp][lane + 32];
        __syncwarp();
        queued -= 32;
      }
    }
  }
  __syncwarp();
  if (lane < queued) bin_queued(queue[warp][lane], qs, pos, nrm, hist, r2);
}

// Scale each of the block's nqb rows to sum 100 and write it with its pair
// count to output row row0 + q, or rows[q] where rows is given.
__device__ __forceinline__ void write_rows(const unsigned int (*hist)[kHist],
                                           int nqb, long long row0,
                                           const long long* rows,
                                           float* __restrict__ hist_out,
                                           float* __restrict__ total_out) {
  for (int i = threadIdx.x; i < nqb * 3 * kBins; i += kThreads) {
    const int q = i / (3 * kBins), k = i % (3 * kBins);
    const long long r = rows ? rows[q] : row0 + q;
    const float total = static_cast<float>(hist[q][3 * kBins]);
    const float scale = total > 0.f ? 100.f / fmaxf(total, 1.f) : 0.f;
    hist_out[r * (3 * kBins) + k] = static_cast<float>(hist[q][k]) * scale;
  }
  for (int q = threadIdx.x; q < nqb; q += kThreads) {
    total_out[rows ? rows[q] : row0 + q] = static_cast<float>(hist[q][3 * kBins]);
  }
}

__global__ void __launch_bounds__(kThreads)
spfh_shared_kernel(const float* __restrict__ q_xyz,
                   const float* __restrict__ q_nrm, int nq, int group,
                   const float4* __restrict__ s_pos,
                   const float4* __restrict__ s_nrm,
                   const int* __restrict__ starts, float cell, float r2,
                   float r2_hi, float* __restrict__ hist_out,
                   float* __restrict__ total_out) {
  __shared__ float qs[6][kGroupMax];            // query xyz, normal
  __shared__ int qcell[3][kGroupMax];
  __shared__ unsigned int hist[kGroupMax][kHist];
  __shared__ unsigned int seen[kTable / 32];    // buckets taken, one bit each
  __shared__ int blist[kMaxBuckets];            // the distinct buckets, then
                                                // their first sorted candidate
  __shared__ int bpre[kMaxBuckets + 1];         // their candidates, scanned
  __shared__ float4 pos[kStage], nrm[kStage];   // the staged candidates
  __shared__ int queue[kWarps][kQueue];         // (query << 16) | candidate
  __shared__ int n_buckets;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = static_cast<long long>(blockIdx.x) * group;
  const int nqb = static_cast<int>(min(static_cast<long long>(group), nq - q0));

  // 1. the group's queries and cells; zeroed counters and bucket set
  for (int i = tid; i < nqb; i += kThreads) {
    const long long r = 3 * (q0 + i);
    for (int c = 0; c < 3; ++c) {
      qs[c][i] = q_xyz[r + c];
      qs[3 + c][i] = q_nrm[r + c];
      qcell[c][i] = cell_of(qs[c][i], cell);
    }
  }
  for (int i = tid; i < nqb * kHist; i += kThreads) hist[i / kHist][i % kHist] = 0u;
  for (int i = tid; i < kTable / 32; i += kThreads) seen[i] = 0u;
  if (tid == 0) n_buckets = 0;
  __syncthreads();

  // 2. the distinct buckets of the 27 cells around each query
  for (int i = tid; i < nqb * 27; i += kThreads) {
    const int q = i / 27, o = i % 27;
    const int h = bucket_of(qcell[0][q] + o % 3 - 1,
                            qcell[1][q] + (o / 3) % 3 - 1,
                            qcell[2][q] + o / 9 - 1);
    const unsigned int bit = 1u << (h & 31);
    if (!(atomicOr(&seen[h >> 5], bit) & bit)) blist[atomicAdd(&n_buckets, 1)] = h;
  }
  __syncthreads();
  const int nb = n_buckets;

  // 3. exclusive scan of the buckets' candidate counts (one warp: each lane
  //    a contiguous run, then a shuffle scan of the runs); blist[k] becomes
  //    the bucket's first sorted candidate
  if (warp == 0) {
    const int per = (nb + 31) / 32;
    const int lo = min(lane * per, nb), hi = min(lo + per, nb);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += starts[blist[k] + 1] - starts[blist[k]];
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int k = lo; k < hi; ++k) {
      const int first = starts[blist[k]];
      bpre[k] = run;
      run += starts[blist[k] + 1] - first;
      blist[k] = first;
    }
    if (lane == 31) bpre[nb] = incl;
  }
  __syncthreads();
  const int n_cand = bpre[nb];

  // 4. stage the candidates and sweep them
  for (int s0 = 0; s0 < n_cand; s0 += kStage) {
    const int n = min(kStage, n_cand - s0);
    for (int j = tid; j < n; j += kThreads) {
      const int g = stage_index(s0 + j, bpre, blist, nb);
      pos[j] = s_pos[g];
      nrm[j] = s_nrm[g];
    }
    __syncthreads();
    sweep_stage(qs, nqb, pos, nrm, n, queue, hist, r2, r2_hi);
    __syncthreads();  // the stage is read by no one any more
  }

  // 5. scale each row to sum 100
  write_rows(hist, nqb, q0, nullptr, hist_out, total_out);
}

__global__ void __launch_bounds__(kThreads)
spfh_grid_kernel(const float* __restrict__ cell_xyz,
                 const long long* __restrict__ cell_idx,
                 const int* __restrict__ count,
                 const unsigned char* __restrict__ q_ok,
                 const int* __restrict__ active, int cap, int gx, int gy,
                 int gz, const float* __restrict__ normals, float r2,
                 float r2_hi, float* __restrict__ hist_out,
                 float* __restrict__ total_out) {
  __shared__ float qs[6][kGroupMax];            // query xyz, normal
  __shared__ int qslot[kGridGroup];             // the queries' slots
  __shared__ long long rows[kGridGroup];        // their output rows
  __shared__ unsigned int hist[kGridGroup][kHist];
  __shared__ int bfirst[kNeighbors];            // each bucket's first slot
  __shared__ int bpre[kNeighbors + 1];          // their filled slots, scanned
  __shared__ float4 pos[kStage], nrm[kStage];   // the staged candidates
  __shared__ int queue[kWarps][kQueue];         // (query << 16) | candidate
  __shared__ int n_q, n_b;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = active[blockIdx.x];
  const long long base = static_cast<long long>(b) * cap;
  const int g0 = blockIdx.y * kGridGroup;

  if (warp == 0) {
    // 1. the block's queries: the needed filled slots of bucket b whose
    //    rank among them lies in [g0, g0 + kGridGroup)
    const int filled = count[b];
    int seen = 0;  // warp-uniform
    for (int s0 = 0; s0 < filled && seen < g0 + kGridGroup; s0 += 32) {
      const int s = s0 + lane;
      const bool need = s < filled && q_ok[base + s];
      const unsigned int m = __ballot_sync(0xffffffffu, need);
      const int r = seen + __popc(m & ((1u << lane) - 1u));
      if (need && r >= g0 && r < g0 + kGridGroup) qslot[r - g0] = s;
      seen += __popc(m);
    }
    if (lane == 0) n_q = min(max(seen - g0, 0), kGridGroup);
  } else if (warp == 1) {
    // 2. the distinct filled buckets among the 27 wrapped neighbours of b
    //    (a lane each; on an axis of 1 or 2 cells ids repeat, and only the
    //    first copy is kept), and an exclusive scan of their counts
    const int bx = b % gx, by = (b / gx) % gy, bz = b / (gx * gy);
    int id = -1;
    if (lane < kNeighbors) {
      const int nx = (bx + lane % 3 - 1 + gx) % gx;
      const int ny = (by + (lane / 3) % 3 - 1 + gy) % gy;
      const int nz = (bz + lane / 9 - 1 + gz) % gz;
      id = (nz * gy + ny) * gx + nx;
    }
    bool dup = false;
    for (int k = 0; k < kNeighbors; ++k) {
      const int other = __shfl_sync(0xffffffffu, id, k);
      dup |= k < lane && other == id;
    }
    const int cnt = (id >= 0 && !dup) ? count[id] : 0;
    const unsigned int keep = __ballot_sync(0xffffffffu, cnt > 0);
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (cnt > 0) {
      const int k = __popc(keep & ((1u << lane) - 1u));
      bfirst[k] = id * cap;
      bpre[k] = incl - cnt;
    }
    if (lane == 31) {
      n_b = __popc(keep);
      bpre[__popc(keep)] = incl;
    }
  }
  __syncthreads();
  const int nqb = n_q;
  if (nqb == 0) return;  // a group past the bucket's needed slots

  // 3. the queries' coordinates, normals and output rows; zeroed counters
  for (int i = tid; i < nqb; i += kThreads) {
    const long long g = base + qslot[i];
    const long long r = cell_idx[g];
    rows[i] = r;
    for (int c = 0; c < 3; ++c) {
      qs[c][i] = cell_xyz[3 * g + c];
      qs[3 + c][i] = normals[3 * r + c];
    }
  }
  for (int i = tid; i < nqb * kHist; i += kThreads) hist[i / kHist][i % kHist] = 0u;
  __syncthreads();
  const int nb = n_b, n_cand = bpre[nb];

  // 4. stage the filled slots of the buckets and sweep them
  for (int s0 = 0; s0 < n_cand; s0 += kStage) {
    const int n = min(kStage, n_cand - s0);
    for (int j = tid; j < n; j += kThreads) {
      const long long g = stage_index(s0 + j, bpre, bfirst, nb);
      const long long r = cell_idx[g];
      pos[j] = make_float4(cell_xyz[3 * g], cell_xyz[3 * g + 1],
                           cell_xyz[3 * g + 2], 0.f);
      nrm[j] = make_float4(normals[3 * r], normals[3 * r + 1],
                           normals[3 * r + 2], 0.f);
    }
    __syncthreads();
    sweep_stage(qs, nqb, pos, nrm, n, queue, hist, r2, r2_hi);
    __syncthreads();  // the stage is read by no one any more
  }

  // 5. scale each row to sum 100, written at the slot's point index
  write_rows(hist, nqb, 0, rows, hist_out, total_out);
}

}  // namespace

// Shared mode. q_xyz, q_nrm (nq, 3) f32, taken `group` rows to a block
// (group <= 64); c_xyz, c_nrm (m, 3) f32, c_ok (m,) bool, the one candidate
// cloud; cell the cell edge. Scratch: ints (m + 3 * 2^15 + 1) i32, sorted
// (2, m, 4) f32. hist_out (nq, 33) f32, total_out (nq,) f32.
// Returns cudaGetLastError() after the launches.
extern "C" int mm_spfh_shared(const float* q_xyz, const float* q_nrm, int nq,
                              int group, const float* c_xyz,
                              const float* c_nrm, const unsigned char* c_ok,
                              int m, float cell, float r2, float r2_hi,
                              int* ints, float* sorted, float* hist_out,
                              float* total_out, void* stream) {
  if (group < 1 || group > kGroupMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = ints;
  int* starts = counts + kTable;          // kTable + 1
  int* cursor = starts + kTable + 1;
  int* cand_bucket = cursor + kTable;     // m
  float4* s_pos = reinterpret_cast<float4*>(sorted);
  float4* s_nrm = s_pos + m;
  cudaError_t err = cudaMemsetAsync(counts, 0, kTable * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bin_blocks = (m + kBinThreads - 1) / kBinThreads;
  if (m > 0) {
    bin_count_kernel<<<bin_blocks, kBinThreads, 0, s>>>(c_xyz, c_ok, m, cell,
                                                       cand_bucket, counts);
  }
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, starts, cursor);
  if (m > 0) {
    bin_scatter_kernel<<<bin_blocks, kBinThreads, 0, s>>>(
        c_xyz, c_nrm, m, cand_bucket, cursor, s_pos, s_nrm);
  }
  const int blocks = (nq + group - 1) / group;
  spfh_shared_kernel<<<blocks, kThreads, 0, s>>>(
      q_xyz, q_nrm, nq, group, s_pos, s_nrm, starts, cell, r2, r2_hi,
      hist_out, total_out);
  return static_cast<int>(cudaGetLastError());
}

// Grid mode, one cloud. The grid of ops/grid.py:build_grid, h = gx gy gz
// buckets of cap slots: cell_xyz (h, cap, 3) f32, cell_idx (h, cap) i64 the
// point index of each slot, count (h,) i32 its filled slots (slots
// [0, count) hold points); q_ok (h, cap) bool the needed slots; active
// (n_active,) i32 the buckets that hold one; normals (p, 3) f32 by point
// index. Writes the needed slots' rows of hist_out (p, 33) f32 and
// total_out (p,) f32, and no other row.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_spfh_grid(const float* cell_xyz, const long long* cell_idx,
                            const int* count, const unsigned char* q_ok,
                            const int* active, int n_active, int cap, int gx,
                            int gy, int gz, const float* normals, float r2,
                            float r2_hi, float* hist_out, float* total_out,
                            void* stream) {
  const int groups = (cap + kGridGroup - 1) / kGridGroup;
  if (n_active < 1 || cap < 1 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_active, groups);
  spfh_grid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cell_xyz, cell_idx, count, q_ok, active, cap, gx, gy, gz, normals, r2,
      r2_hi, hist_out, total_out);
  return static_cast<int>(cudaGetLastError());
}
