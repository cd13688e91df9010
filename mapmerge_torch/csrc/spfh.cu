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
// Per-cell mode (batch i's queries against batch i's candidates: the grid
// engine's SPFH sweep, ops/descriptors/fpfh.py:_spfh_grid, one batch per
// bucket that holds a needed point, Cq = the bucket cap, M = 27 x the cap),
// spfh_cell_kernel: one thread per query slot sweeps its bucket's
// candidates, staged in shared memory. A simple kernel: every slot of a
// bucket is swept, needed or not, and each candidate costs one distance
// test per slot.
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

// shared mode
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

// per-cell mode
constexpr int kCellThreads = 128;
constexpr int kChunk = 256;

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

  // 4. stage the candidates, test every (query, candidate) pair, queue the
  //    hits, and bin them 32 at a time
  int queued = 0;  // warp-uniform
  for (int s0 = 0; s0 < n_cand; s0 += kStage) {
    const int n = min(kStage, n_cand - s0);
    for (int j = tid; j < n; j += kThreads) {
      // the bucket holding staged candidate s0 + j: last k with bpre[k] <= i
      const int i = s0 + j;
      int lo = 0, hi = nb - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (bpre[mid] <= i) lo = mid; else hi = mid - 1;
      }
      const int g = blist[lo] + (i - bpre[lo]);
      pos[j] = s_pos[g];
      nrm[j] = s_nrm[g];
    }
    __syncthreads();
    for (int q = warp; q < nqb; q += kWarps) {
      const float px = qs[0][q], py = qs[1][q], pz = qs[2][q];
      for (int j0 = 0; j0 < n; j0 += 32) {
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
    queued = 0;
    __syncthreads();  // the stage is read by no one any more
  }

  // 5. scale each row to sum 100
  for (int i = tid; i < nqb * 3 * kBins; i += kThreads) {
    const int q = i / (3 * kBins), k = i % (3 * kBins);
    const float total = static_cast<float>(hist[q][3 * kBins]);
    const float scale = total > 0.f ? 100.f / fmaxf(total, 1.f) : 0.f;
    hist_out[q0 * (3 * kBins) + i] = static_cast<float>(hist[q][k]) * scale;
  }
  for (int q = tid; q < nqb; q += kThreads) {
    total_out[q0 + q] = static_cast<float>(hist[q][3 * kBins]);
  }
}

__global__ void __launch_bounds__(kCellThreads)
spfh_cell_kernel(const float* __restrict__ q_xyz,
                 const float* __restrict__ q_nrm, int cq,
                 const float* __restrict__ c_xyz,
                 const float* __restrict__ c_nrm,
                 const unsigned char* __restrict__ c_ok, int m, float r2,
                 float* __restrict__ hist_out, float* __restrict__ total_out) {
  __shared__ float cand[7][kChunk];
  __shared__ unsigned int hist[kHist][kCellThreads];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int qi = blockIdx.y * kCellThreads + tid;
  const bool active = qi < cq;
  const long long qrow = b * cq + qi;

  float px = 0.f, py = 0.f, pz = 0.f, n1x = 0.f, n1y = 0.f, n1z = 0.f;
  if (active) {
    px = q_xyz[3 * qrow];
    py = q_xyz[3 * qrow + 1];
    pz = q_xyz[3 * qrow + 2];
    n1x = q_nrm[3 * qrow];
    n1y = q_nrm[3 * qrow + 1];
    n1z = q_nrm[3 * qrow + 2];
  }
  // bin-major counters, hist[bin][thread]: no atomics, no local memory
#pragma unroll
  for (int k = 0; k < kHist; ++k) hist[k][tid] = 0u;

  const long long cbase = b * m;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int n = min(kChunk, m - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = tid; j < n; j += kCellThreads) {
      const long long g = cbase + c0 + j;
      cand[0][j] = c_xyz[3 * g];
      cand[1][j] = c_xyz[3 * g + 1];
      cand[2][j] = c_xyz[3 * g + 2];
      cand[3][j] = c_nrm[3 * g];
      cand[4][j] = c_nrm[3 * g + 1];
      cand[5][j] = c_nrm[3 * g + 2];
      cand[6][j] = c_ok[g] ? 1.f : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      if (cand[6][j] == 0.f) continue;
      int bt, ba, bp;
      if (pair_bins(px, py, pz, n1x, n1y, n1z, cand[0][j], cand[1][j],
                    cand[2][j], cand[3][j], cand[4][j], cand[5][j], r2, &bt,
                    &ba, &bp)) {
        hist[bt][tid] += 1u;
        hist[ba][tid] += 1u;
        hist[bp][tid] += 1u;
        hist[3 * kBins][tid] += 1u;
      }
    }
  }
  if (!active) return;
  const float total = static_cast<float>(hist[3 * kBins][tid]);
  const float scale = total > 0.f ? 100.f / fmaxf(total, 1.f) : 0.f;
  float* out = hist_out + qrow * (3 * kBins);
#pragma unroll
  for (int k = 0; k < 3 * kBins; ++k) {
    out[k] = static_cast<float>(hist[k][tid]) * scale;
  }
  total_out[qrow] = total;
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

// Per-cell mode. q_xyz, q_nrm (b, cq, 3) f32; c_xyz, c_nrm (b, m, 3) f32,
// c_ok (b, m) bool: batch i's queries see batch i's candidates.
// hist_out (b, cq, 33) f32, total_out (b, cq) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_spfh_cell(const float* q_xyz, const float* q_nrm, int cq,
                            int b, const float* c_xyz, const float* c_nrm,
                            const unsigned char* c_ok, int m, float r2,
                            float* hist_out, float* total_out, void* stream) {
  const dim3 grid(b, (cq + kCellThreads - 1) / kCellThreads);
  spfh_cell_kernel<<<grid, kCellThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_xyz, q_nrm, cq, c_xyz, c_nrm, c_ok, m, r2, hist_out, total_out);
  return static_cast<int>(cudaGetLastError());
}
