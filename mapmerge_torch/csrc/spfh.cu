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
// units. A pair costs ~70 FP32 operations, two square roots, six divisions
// and one atan2; the main path sweeps 24,576 queries x 32,768
// candidates (8.1e8 pairs) per cloud. Candidates are read once per block from
// L2; the output is 136 B per query.
//
// Design: one thread per query, 128 threads per block, grid (batch, query
// blocks). Candidate chunks are staged in shared memory as 7 planes (x, y, z,
// nx, ny, nz, ok); all threads read the same candidate at once (a
// broadcast). Each thread keeps its 34 counts in shared memory laid out
// bin-major, hist[bin][threadIdx.x]: neighbouring threads touch neighbouring
// banks, no atomics are needed, and no per-thread array is indexed at run
// time (which would spill to local memory). Counts stay exact integers until
// the final sum-100 scale. Candidate stride 0 is the shared-candidate mode
// (every query sees the same cloud); stride M is the per-cell mode.
// The library is built with -fmad=false so every product and sum is rounded
// as the plain PyTorch version (kernels/spfh.py: spfh_ref) rounds it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;
constexpr int kBins = 11;
constexpr int kHist = 3 * kBins + 1;  // 33 bins + pair count
constexpr float kEps = 1.0e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ int bin_index(float value, float lo, float span) {
  // floor((value - lo) / span * bins), clipped (darboux.bin_index)
  const int i = static_cast<int>(floorf((value - lo) / span * kBins));
  return min(max(i, 0), kBins - 1);
}

__global__ void __launch_bounds__(kThreads)
spfh_kernel(const float* __restrict__ q_xyz, const float* __restrict__ q_nrm,
            int cq, const float* __restrict__ c_xyz,
            const float* __restrict__ c_nrm,
            const unsigned char* __restrict__ c_ok, int m,
            long long c_stride, float r2, float* __restrict__ hist_out,
            float* __restrict__ total_out) {
  __shared__ float cand[7][kChunk];
  __shared__ unsigned int hist[kHist][kThreads];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int qi = blockIdx.y * kThreads + tid;
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
#pragma unroll
  for (int k = 0; k < kHist; ++k) hist[k][tid] = 0u;

  const long long cbase = b * c_stride;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int n = min(kChunk, m - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = tid; j < n; j += kThreads) {
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
      const float n2x = cand[3][j], n2y = cand[4][j], n2z = cand[5][j];
      // d = p2 - p1 (candidate - query)
      const float dx = cand[0][j] - px;
      const float dy = cand[1][j] - py;
      const float dz = cand[2][j] - pz;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      if (!(dist2 > kEps)) continue;  // coincident points
      const float dist = sqrtf(fmaxf(dist2, kEps));
      if (!(dist * dist <= r2)) continue;
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
      if (!(vnorm2 > kEps)) continue;  // degenerate frame
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

      hist[bin_index(theta, -kPi, kTwoPi)][tid] += 1u;
      hist[kBins + bin_index(alpha, -1.f, 2.f)][tid] += 1u;
      hist[2 * kBins + bin_index(phi, -1.f, 2.f)][tid] += 1u;
      hist[3 * kBins][tid] += 1u;
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

// q_xyz, q_nrm (b, cq, 3) f32; c_xyz, c_nrm (bc, m, 3) f32; c_ok (bc, m)
// bool; c_stride = 0 (shared candidates, bc = 1) or m (per-batch
// candidates, bc = b). hist_out (b, cq, 33) f32, total_out (b, cq) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_spfh(const float* q_xyz, const float* q_nrm, int cq, int b,
                       const float* c_xyz, const float* c_nrm,
                       const unsigned char* c_ok, int m, long long c_stride,
                       float r2, float* hist_out, float* total_out,
                       void* stream) {
  const dim3 grid(b, (cq + kThreads - 1) / kThreads);
  spfh_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_xyz, q_nrm, cq, c_xyz, c_nrm, c_ok, m, c_stride, r2, hist_out,
      total_out);
  return static_cast<int>(cudaGetLastError());
}
