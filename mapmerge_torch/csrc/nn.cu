// Exact 1-nearest-neighbour for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mapmerge_tpu/pallas/nn.py
// (nearest_neighbor_pallas / _nn_kernel): for each query, the index and
// squared distance of the nearest target, with masked targets penalised by
// +BIG (1e12) added to their squared distance, and ties resolved to the first
// occurrence (jnp.argmin semantics).
//
// What bounds it on the card: FP32 issue on the CUDA cores. A (query,
// target) pair costs 3 subtractions, 3 multiplies, 3 adds, a compare and two
// selects; at the main path's Q = P = 32768 that is 1.07e9 pairs per call,
// while the bytes moved are small (12 B per query, 16 B per target per block,
// mostly from L2). The contraction depth is 3, so tensor cores have no role.
// Bit parity with the plain version forbids FMA contraction, so the ceiling
// is the issue rate of ~12 non-FMA instructions a pair, not the FMA peak.
//
// Design: the grid is (query tiles, P splits, pairs). A block of 128 threads holds
// 512 queries, 4 per thread in registers, and sweeps one contiguous split of
// the targets, staged through shared memory as float4 (x, y, z, penalty); all
// threads read the same element at once (a broadcast) and each read feeds 4
// independent dependency chains. A tile without masked targets skips the
// penalty add (x + 0 = x for every d2 >= 0), and the running minimum is a
// min and a select, with no branch. The wrapper picks the number of splits so
// that the grid has about 16 blocks per SM at both main-path sizes (32768
// and 14397 queries): short blocks keep the tail of the grid short. Each split writes its (d2, idx) per query to scratch that
// the wrapper allocates; nn_reduce_kernel then takes the splits in
// increasing order with a strict `<`. Each split keeps its first occurrence
// the same way, so ties resolve to the first index and the result is
// deterministic. Ragged edges of Q and P are masked here; no padding rows
// are needed. mm_nearest_neighbor_batched runs B independent (q, p,
// mask) problems of one shape in one launch, each pair on the grid's z
// index with its own slices of the operands and scratch, so a pair's row is
// the same bits in a batch or alone (the minimum over splits, ties to the first index, does not
// depend on how many splits the wrapper picks). The wrapper's single entry
// launches a batch of one. The arithmetic goes through __fsub_rn / __fmul_rn /
// __fadd_rn, which nvcc never contracts into FMAs, so every product and sum
// is rounded exactly as the plain PyTorch version (kernels/nn.py:
// nearest_neighbor_ref) rounds it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kQueries = kThreads * kPerThread;  // queries per block
constexpr int kTile = 1024;                       // targets per stage
constexpr int kReduceThreads = 256;
constexpr float kBig = 1.0e12f;

// One staged tile against the thread's queries. kPenalty: the tile holds a
// masked target (without one, adding its 0 penalty changes no value, so the
// add is left out).
template <bool kPenalty>
__device__ __forceinline__ void sweep_tile(const float4* tile, int n, int t0,
                                           const float* qx, const float* qy,
                                           const float* qz, float* best,
                                           int* best_i) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 t = tile[j];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float dx = __fsub_rn(qx[k], t.x);
      const float dy = __fsub_rn(qy[k], t.y);
      const float dz = __fsub_rn(qz[k], t.z);
      float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                           __fmul_rn(dz, dz));
      if (kPenalty) d2 = __fadd_rn(d2, t.w);
      // strict: the first occurrence stays on ties
      best_i[k] = d2 < best[k] ? t0 + j : best_i[k];
      best[k] = fminf(best[k], d2);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nn_split_kernel(const float* __restrict__ q, int nq,
                const float* __restrict__ p,
                const unsigned char* __restrict__ p_mask, int np,
                int split_len, int* __restrict__ part_idx,
                float* __restrict__ part_d2) {
  __shared__ float4 tile[kTile];
  // pair b of the batch: its queries, targets, mask and (splits, nq) scratch
  const long long b = blockIdx.z;
  q += b * nq * 3;
  p += b * np * 3;
  if (p_mask != nullptr) p_mask += b * np;
  part_idx += b * gridDim.y * static_cast<long long>(nq);
  part_d2 += b * gridDim.y * static_cast<long long>(nq);
  const int split = blockIdx.y;
  const int p_begin = split * split_len;
  const int p_end = min(np, p_begin + split_len);

  // thread t holds queries base + t + k * kThreads: coalesced loads, stores
  const int base = blockIdx.x * kQueries + threadIdx.x;
  float qx[kPerThread], qy[kPerThread], qz[kPerThread], best[kPerThread];
  int best_i[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long qi = base + k * kThreads;
    const bool active = qi < nq;
    qx[k] = active ? q[3 * qi] : 0.f;
    qy[k] = active ? q[3 * qi + 1] : 0.f;
    qz[k] = active ? q[3 * qi + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);  // +inf
    best_i[k] = 0;
  }
  for (int t0 = p_begin; t0 < p_end; t0 += kTile) {
    const int n = min(kTile, p_end - t0);
    __syncthreads();  // the previous tile is no longer read
    bool masked = false;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long g = t0 + j;
      const bool off = p_mask != nullptr && p_mask[g] == 0;
      masked |= off;
      tile[j] = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], off ? kBig : 0.f);
    }
    if (__syncthreads_or(masked)) {
      sweep_tile<true>(tile, n, t0, qx, qy, qz, best, best_i);
    } else {
      sweep_tile<false>(tile, n, t0, qx, qy, qz, best, best_i);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int qi = base + k * kThreads;
    if (qi < nq) {
      part_d2[static_cast<long long>(split) * nq + qi] = best[k];
      part_idx[static_cast<long long>(split) * nq + qi] = best_i[k];
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
nn_reduce_kernel(int nq, int splits, const int* __restrict__ part_idx,
                 const float* __restrict__ part_d2, int* __restrict__ idx_out,
                 float* __restrict__ d2_out) {
  const int qi = blockIdx.x * kReduceThreads + threadIdx.x;
  if (qi >= nq) return;
  const long long b = blockIdx.y;  // pair b of the batch
  part_idx += b * splits * static_cast<long long>(nq);
  part_d2 += b * splits * static_cast<long long>(nq);
  idx_out += b * nq;
  d2_out += b * nq;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int s = 0; s < splits; ++s) {
    const float d2 = part_d2[static_cast<long long>(s) * nq + qi];
    if (d2 < best) {  // strict: an earlier split wins a tie
      best = d2;
      best_i = part_idx[static_cast<long long>(s) * nq + qi];
    }
  }
  idx_out[qi] = best_i;
  d2_out[qi] = best;
}

}  // namespace

// q (batch, nq, 3) f32, p (batch, np, 3) f32, p_mask (batch, np) bool or
// null; part_idx, part_d2 (batch, splits, nq) scratch; idx_out (batch, nq)
// i32, d2_out (batch, nq) f32. Returns cudaGetLastError() after the two
// launches.
extern "C" int mm_nearest_neighbor_batched(const float* q, int batch, int nq,
                                           const float* p,
                                           const unsigned char* p_mask, int np,
                                           int splits, int* part_idx,
                                           float* part_d2, int* idx_out,
                                           float* d2_out, void* stream) {
  if (splits < 1 || splits > 65535 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split_len = (np + splits - 1) / splits;
  const dim3 grid((nq + kQueries - 1) / kQueries, splits, batch);
  nn_split_kernel<<<grid, kThreads, 0, s>>>(q, nq, p, p_mask, np, split_len,
                                            part_idx, part_d2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 reduce_grid((nq + kReduceThreads - 1) / kReduceThreads, batch);
  nn_reduce_kernel<<<reduce_grid, kReduceThreads, 0, s>>>(
      nq, splits, part_idx, part_d2, idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
