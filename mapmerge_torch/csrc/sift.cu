// SIFT's dense octave for Hopper (sm_90a): the Gaussian scale space
// (kernel C) and the 26 nearest neighbours of the extremum test (kernel D).
//
// Neither replaces a Pallas kernel: the JAX package leaves both to XLA.
// Kernel C replaces the dense branch of mapmerge_tpu/ops/keypoints/sift.py
// `_scale_space`; kernel D the dense `radius_neighbors` (mapmerge_tpu/ops/
// neighbors.py) that sift.py calls for the 26-NN. Their plain PyTorch
// versions are kernels/sift.py: scale_space_ref and knn_ref.
//
// Kernel C (mm_sift_scale_space): for each query and each of the S sigmas,
// num / max(den, 1e-12) with num = sum w * val and den = sum w over the
// valid points within r2_bound of the query, w = exp(-d2 / (2 s^2)). d2 is
// the direct expansion of ops/neighbors.sq_dists, ((dx^2 + dy^2) + dz^2) on
// centred float32 coordinates, through __fsub_rn / __fmul_rn / __fadd_rn,
// so it is sq_dists' value bit for bit and the bound test takes the same
// points as the plain version. A point outside the bound, or masked, is
// skipped: the plain version multiplies its weight by 0, which adds nothing.
// The division is IEEE (__fdiv_rn) by the float32 value of 2 s^2 that
// PyTorch uses, and expf (not __expf). num and den are summed in point order
// within a split and the splits in order, so a run repeats bit for bit; the
// plain version's matrix-vector product sums in another order, so the two
// agree to rounding (kernels/sift.py states the tolerance).
//
// Kernel D (mm_sift_knn): for each query the k <= 26 smallest (d2, index)
// pairs in lexicographic order, nearest first, with masked targets at d2 =
// BIG (1e12) as in ops/neighbors.radius_neighbors; valid = d2 <= r2. Ties go
// to the lower index, as lax.top_k's order and the plain version's stable
// sort have it. Each thread keeps its query's list sorted in registers and
// sweeps the targets in index order, so a candidate enters only if its d2
// is strictly below the 26th (an equal d2 has the higher index) and goes
// after every held entry of equal d2. Splits of the targets are merged in
// split order by the same rule: the result is exact and does not depend on
// the number of splits.
//
// What bounds them on the card: FP32 issue on the CUDA cores. Each (query,
// point) pair costs the distance (3 subtractions, 3 products, 2 sums), a
// compare and a select; C adds S divisions, expf, a product and two sums for
// each pair within the bound (about 1% at config #1's octave 0), D a
// 26-slot register insertion for each candidate below the current 26th.
// The bytes are small (16 B a point a block, mostly from L2). No FMA
// contraction (-fmad=false), no atomics, no fast-math.
//
// Design (as csrc/nn.cu): the grid is (query tiles, P splits[, sigma
// groups]). A block stages a tile of points (x, y, z, value or mask) in
// shared memory as float4 and every thread reads the same element at once (a
// broadcast). C holds 4 queries a thread, each with the num and den of up to
// kGroup sigmas in registers; larger S runs ceil(S / kGroup) groups on the
// grid's z axis, each recomputing the distances. D holds one query a thread
// and its 26 (d2, index) pairs. Each split writes its partial results to
// scratch that the wrapper allocates; a second kernel merges the splits in
// order. The wrapper picks the splits from Q and P alone, so the bits of C
// do not depend on the card. Masked points are staged with a NaN x for C
// (d2 is NaN and fails the bound test) and a flag in w for D.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // points per stage
constexpr int kReduceThreads = 256;
constexpr float kBig = 1.0e12f;

// ---- kernel C ----
constexpr int kPerThread = 4;
constexpr int kQueries = kThreads * kPerThread;  // queries per block
constexpr int kGroup = 8;                        // sigmas per block

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 t) {
  const float dx = __fsub_rn(qx, t.x);
  const float dy = __fsub_rn(qy, t.y);
  const float dz = __fsub_rn(qz, t.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
scale_space_split_kernel(const float* __restrict__ q, int nq,
                         const float* __restrict__ p,
                         const float* __restrict__ vals,
                         const unsigned char* __restrict__ p_mask, int np,
                         const float* __restrict__ two_s2, int n_sigma,
                         float r2_bound, int split_len,
                         float* __restrict__ part_num,
                         float* __restrict__ part_den) {
  __shared__ float4 tile[kTile];
  const int split = blockIdx.y;
  const int p_begin = split * split_len;
  const int p_end = min(np, p_begin + split_len);
  const int g0 = blockIdx.z * kGroup;
  const int ng = min(kGroup, n_sigma - g0);
  float denom[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) denom[g] = g < ng ? two_s2[g0 + g] : 1.f;

  // thread t holds queries base + t + k * kThreads: coalesced loads, stores
  const int base = blockIdx.x * kQueries + threadIdx.x;
  float qx[kPerThread], qy[kPerThread], qz[kPerThread];
  float num[kPerThread][kGroup], den[kPerThread][kGroup];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long qi = base + k * kThreads;
    const bool active = qi < nq;
    qx[k] = active ? q[3 * qi] : 0.f;
    qy[k] = active ? q[3 * qi + 1] : 0.f;
    qz[k] = active ? q[3 * qi + 2] : 0.f;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) num[k][g] = den[k][g] = 0.f;
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int t0 = p_begin; t0 < p_end; t0 += kTile) {
    const int n = min(kTile, p_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long g = t0 + j;
      const bool off = p_mask != nullptr && p_mask[g] == 0;
      tile[j] = make_float4(off ? nan : p[3 * g], p[3 * g + 1], p[3 * g + 2],
                            vals[g]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float d2 = sq_dist(qx[k], qy[k], qz[k], t);
        if (d2 <= r2_bound) {  // false for NaN: a masked point
          const float neg = -d2;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g < ng) {
              const float w = expf(__fdiv_rn(neg, denom[g]));
              num[k][g] = __fadd_rn(num[k][g], __fmul_rn(w, t.w));
              den[k][g] = __fadd_rn(den[k][g], w);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int qi = base + k * kThreads;
    if (qi >= nq) continue;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < ng) {
        const long long at =
            (static_cast<long long>(split) * n_sigma + g0 + g) * nq + qi;
        part_num[at] = num[k][g];
        part_den[at] = den[k][g];
      }
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
scale_space_reduce_kernel(int nq, int n_sigma, int splits,
                          const float* __restrict__ part_num,
                          const float* __restrict__ part_den,
                          float* __restrict__ out) {
  const int qi = blockIdx.x * kReduceThreads + threadIdx.x;
  if (qi >= nq) return;
  const int s = blockIdx.y;
  float num = part_num[static_cast<long long>(s) * nq + qi];
  float den = part_den[static_cast<long long>(s) * nq + qi];
  for (int sp = 1; sp < splits; ++sp) {  // in split order
    const long long at = (static_cast<long long>(sp) * n_sigma + s) * nq + qi;
    num = __fadd_rn(num, part_num[at]);
    den = __fadd_rn(den, part_den[at]);
  }
  out[static_cast<long long>(s) * nq + qi] = __fdiv_rn(num, fmaxf(den, 1e-12f));
}

// ---- kernel D ----
constexpr int kK = 26;  // list length: the 25-NN plus the point itself

// (d, j) into a list sorted by (d2, index) whose indices are all below j
// (the caller has checked d < dist[kK - 1]): it goes after every entry with
// d2 <= d, and the entries after it move down one slot. Each slot reads the
// old values of itself and its predecessor, so the slots are written from
// the last to the first.
__device__ __forceinline__ void insert(float (&dist)[kK], int (&idx)[kK],
                                       float d, int j) {
#pragma unroll
  for (int i = kK - 1; i > 0; --i) {
    const bool shift = dist[i - 1] > d;
    const bool here = !shift && dist[i] > d;
    dist[i] = shift ? dist[i - 1] : (here ? d : dist[i]);
    idx[i] = shift ? idx[i - 1] : (here ? j : idx[i]);
  }
  if (dist[0] > d) {
    dist[0] = d;
    idx[0] = j;
  }
}

__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const float* __restrict__ q, int nq,
                 const float* __restrict__ p,
                 const unsigned char* __restrict__ p_mask, int np,
                 int split_len, float* __restrict__ part_d2,
                 int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  const int split = blockIdx.y;
  const int p_begin = split * split_len;
  const int p_end = min(np, p_begin + split_len);
  const long long qi = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const bool active = qi < nq;
  const float qx = active ? q[3 * qi] : 0.f;
  const float qy = active ? q[3 * qi + 1] : 0.f;
  const float qz = active ? q[3 * qi + 2] : 0.f;
  float dist[kK];
  int idx[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    dist[i] = __int_as_float(0x7f800000);  // +inf: filled by the first kK
    idx[i] = -1;
  }
  for (int t0 = p_begin; t0 < p_end; t0 += kTile) {
    const int n = min(kTile, p_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long g = t0 + j;
      const bool off = p_mask != nullptr && p_mask[g] == 0;
      tile[j] = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], off ? 1.f : 0.f);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
      float d2 = sq_dist(qx, qy, qz, t);
      d2 = t.w != 0.f ? kBig : d2;  // a masked target: BIG, not added
      if (d2 < dist[kK - 1]) insert(dist, idx, d2, t0 + j);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const long long at = (static_cast<long long>(split) * kK + i) * nq + qi;
    part_d2[at] = dist[i];
    part_idx[at] = idx[i];
  }
}

__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(int nq, int splits, int k, float r2,
                 const float* __restrict__ part_d2,
                 const int* __restrict__ part_idx, int* __restrict__ idx_out,
                 unsigned char* __restrict__ valid_out) {
  const long long qi = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (qi >= nq) return;
  float dist[kK];
  int idx[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    dist[i] = part_d2[i * nq + qi];
    idx[i] = part_idx[i * nq + qi];
  }
  // a later split's entries all have higher indices than the list's, and
  // come sorted: the first that does not enter ends that split
  for (int sp = 1; sp < splits; ++sp) {
    for (int i = 0; i < kK; ++i) {
      const long long at = (static_cast<long long>(sp) * kK + i) * nq + qi;
      const float d = part_d2[at];
      if (!(d < dist[kK - 1])) break;
      insert(dist, idx, d, part_idx[at]);
    }
  }
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    if (i < k) {
      idx_out[qi * k + i] = idx[i];
      valid_out[qi * k + i] = dist[i] <= r2;
    }
  }
}

}  // namespace

// q (nq, 3), p (np, 3) f32, centred alike; vals (np,) f32; p_mask (np,)
// bool or null; two_s2 (n_sigma,) f32 on the card; part_num, part_den
// (splits, n_sigma, nq) scratch; out (n_sigma, nq) f32. Returns
// cudaGetLastError() after the two launches.
extern "C" int mm_sift_scale_space(const float* q, int nq, const float* p,
                                   const float* vals,
                                   const unsigned char* p_mask, int np,
                                   const float* two_s2, int n_sigma,
                                   float r2_bound, int splits, float* part_num,
                                   float* part_den, float* out, void* stream) {
  const int groups = (n_sigma + kGroup - 1) / kGroup;
  if (splits < 1 || splits > 65535 || n_sigma < 1 || n_sigma > 65535 ||
      groups > 65535 || nq < 1 || np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split_len = (np + splits - 1) / splits;
  const dim3 grid((nq + kQueries - 1) / kQueries, splits, groups);
  scale_space_split_kernel<<<grid, kThreads, 0, s>>>(
      q, nq, p, vals, p_mask, np, two_s2, n_sigma, r2_bound, split_len,
      part_num, part_den);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 reduce_grid((nq + kReduceThreads - 1) / kReduceThreads, n_sigma);
  scale_space_reduce_kernel<<<reduce_grid, kReduceThreads, 0, s>>>(
      nq, n_sigma, splits, part_num, part_den, out);
  return static_cast<int>(cudaGetLastError());
}

// q (nq, 3), p (np, 3) f32, centred alike; p_mask (np,) bool or null;
// 1 <= k <= 26; part_d2, part_idx (splits, 26, nq) scratch; idx_out (nq, k)
// i32, valid_out (nq, k) bool. Returns cudaGetLastError() after the two
// launches.
extern "C" int mm_sift_knn(const float* q, int nq, const float* p,
                           const unsigned char* p_mask, int np, int k, float r2,
                           int splits, float* part_d2, int* part_idx,
                           int* idx_out, unsigned char* valid_out,
                           void* stream) {
  if (splits < 1 || splits > 65535 || k < 1 || k > kK || k > np || nq < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split_len = (np + splits - 1) / splits;
  const dim3 grid((nq + kThreads - 1) / kThreads, splits);
  knn_split_kernel<<<grid, kThreads, 0, s>>>(q, nq, p, p_mask, np, split_len,
                                             part_d2, part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      nq, splits, k, r2, part_d2, part_idx, idx_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
