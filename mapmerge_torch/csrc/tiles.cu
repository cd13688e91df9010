// The tile pre-pass for Hopper (sm_90a) that the culled dense-neighbourhood
// kernels read: SIFT's kernels C and D (sift.cu); the radius sweeps E and F
// (radius.cu) write this layout with their own. Not a port of a Pallas
// kernel; its plain PyTorch version is kernels/tiles.py: pack_ref.
//
// What it writes (cull.cuh's Stage reads it). For np points p, optional
// values and an optional mask, in tiles of kT = 32 consecutive points:
// - pts (ceil(np / 32) * 32) float4 (x, y, z, value): x = NaN where the
//   point is masked (it fails every distance test, and D reads it as
//   masked), value 0 without values; the rows past np are (NaN, 0, 0, 0);
// - boxes, two float4 a tile: lo = (the least x, y, z of its valid points,
//   its first masked index as int bits, INT_MAX if none) and hi = (the
//   largest, its first point index as int bits); a tile with no valid
//   point has lo = +inf and hi = -inf.
// One warp a tile, one point a lane; the box by shuffles (min and max are
// exact in any order), so a run repeats bit for bit.

#include "cull.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ p, const float* __restrict__ vals,
            const unsigned char* __restrict__ mask, int np, int ntiles,
            float4* __restrict__ pts, float4* __restrict__ boxes) {
  const int tile = blockIdx.x * kWarps + threadIdx.x / 32;
  if (tile >= ntiles) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const long long g = static_cast<long long>(tile) * kT + lane;
  const bool in = g < np;
  const bool valid = in && (mask == nullptr || mask[g] != 0);
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  float x = 0.f, y = 0.f, z = 0.f;
  if (in) {
    x = p[3 * g];
    y = p[3 * g + 1];
    z = p[3 * g + 2];
  }
  pts[g] = make_float4(valid ? x : nan, y, z, in && vals != nullptr ? vals[g] : 0.f);
  Box b{valid ? x : inf, valid ? y : inf, valid ? z : inf,
        valid ? x : -inf, valid ? y : -inf, valid ? z : -inf};
  int first_masked = in && !valid ? static_cast<int>(g) : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.lx = fminf(b.lx, __shfl_xor_sync(kAll, b.lx, o));
    b.ly = fminf(b.ly, __shfl_xor_sync(kAll, b.ly, o));
    b.lz = fminf(b.lz, __shfl_xor_sync(kAll, b.lz, o));
    b.hx = fmaxf(b.hx, __shfl_xor_sync(kAll, b.hx, o));
    b.hy = fmaxf(b.hy, __shfl_xor_sync(kAll, b.hy, o));
    b.hz = fmaxf(b.hz, __shfl_xor_sync(kAll, b.hz, o));
    first_masked = min(first_masked, __shfl_xor_sync(kAll, first_masked, o));
  }
  if (lane == 0) {
    boxes[2 * tile] = make_float4(b.lx, b.ly, b.lz, __int_as_float(first_masked));
    boxes[2 * tile + 1] = make_float4(b.hx, b.hy, b.hz, __int_as_float(tile * kT));
  }
}

}  // namespace

// p (np, 3) f32; vals (np,) f32 or null (0); mask (np,) bool or null (all
// valid); pts (ceil(np / 32) * 32, 4) f32 and boxes (ceil(np / 32), 2, 4)
// f32 written. Returns cudaGetLastError() after the launch.
extern "C" int mm_tiles_pack(const float* p, const float* vals,
                             const unsigned char* mask, int np, float* pts,
                             float* boxes, void* stream) {
  if (np < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (np + kT - 1) / kT;
  pack_kernel<<<(ntiles + kWarps - 1) / kWarps, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      p, vals, mask, np, ntiles, reinterpret_cast<float4*>(pts),
      reinterpret_cast<float4*>(boxes));
  return static_cast<int>(cudaGetLastError());
}
