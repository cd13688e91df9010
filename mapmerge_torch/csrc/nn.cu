// Exact 1-nearest-neighbour for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mapmerge_tpu/pallas/nn.py
// (nearest_neighbor_pallas / _nn_kernel): for each query, the index and
// squared distance of the nearest target, with masked targets penalised by
// +BIG (1e12) added to their squared distance, and ties resolved to the first
// occurrence (jnp.argmin semantics).
//
// What bounds it on the card: FP32 arithmetic on the CUDA cores. A (query,
// target) pair costs 3 subtractions, 3 multiplies, 3 adds and a compare;
// at the main path's Q = P = 32768 that is 1.07e9 pairs per call, while the
// bytes moved are small (12 B per query, 16 B per target per block, mostly
// from L2). The contraction depth is 3, so tensor cores have no role.
//
// Design: one thread per query, 256 threads per block. Target tiles
// (x, y, z, penalty) are staged through shared memory as float4; all threads
// of a block read the same element at once (a broadcast) and scan the tile in
// increasing index order with a strict `<`, which keeps the first occurrence
// on ties within and across tiles. Ragged edges of Q and P are masked here;
// no padding rows are needed. The arithmetic goes through __fsub_rn /
// __fmul_rn / __fadd_rn, which nvcc never contracts into FMAs, so every
// product and sum is rounded exactly as the plain PyTorch version
// (kernels/nn.py: nearest_neighbor_ref) rounds it.
//
// Later tuning: at Q = 32768 this launches 128 blocks, just under the 132 SMs
// of an H100, one block per SM; several queries per thread and split-P blocks
// would fill the card better.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1.0e12f;

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q, int nq,
          const float* __restrict__ p,
          const unsigned char* __restrict__ p_mask, int np,
          int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * static_cast<long long>(qi)];
    qy = q[3 * static_cast<long long>(qi) + 1];
    qz = q[3 * static_cast<long long>(qi) + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int base = 0; base < np; base += kTile) {
    const int n = min(kTile, np - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long g = base + j;
      const float pen = (p_mask != nullptr && p_mask[g] == 0) ? kBig : 0.f;
      tile[j] = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], pen);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4 t = tile[j];
        const float dx = __fsub_rn(qx, t.x);
        const float dy = __fsub_rn(qy, t.y);
        const float dz = __fsub_rn(qz, t.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz)),
            t.w);
        if (d2 < best) {
          best = d2;
          best_i = base + j;
        }
      }
    }
  }
  if (active) {
    idx_out[qi] = best_i;
    d2_out[qi] = best;
  }
}

}  // namespace

// q (nq, 3) f32, p (np, 3) f32, p_mask (np,) bool or null; idx_out (nq,) i32,
// d2_out (nq,) f32. Returns cudaGetLastError() after the launch.
extern "C" int mm_nearest_neighbor(const float* q, int nq, const float* p,
                                   const unsigned char* p_mask, int np,
                                   int* idx_out, float* d2_out,
                                   void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, nq, p, p_mask, np, idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
