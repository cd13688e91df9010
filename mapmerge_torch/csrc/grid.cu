// The cell-grid engine's sweeps for Hopper (sm_90a): the bounded 1-NN
// (kernel G), the radius moments (kernel H), the radius count (kernel I),
// SIFT's Gaussian scale space (kernel J) and its k nearest neighbours
// (kernel K) of every query slot of a query grid against the points of a
// target grid, both grids read in place (core/grid.py: build_grid).
//
// None replaces a Pallas kernel: the JAX package leaves all five to XLA,
// through mapmerge_tpu/ops/grid.py `grid_query`. Kernel G replaces
// `grid_nn_query` (:594; ICP every iteration, and the transform score through
// `grid_nearest_neighbor`), kernel H `grid_neighbor_moments` (:754; the
// surface normals), kernel I `grid_radius_count` (:397; outlier removal),
// kernel J `grid_gaussian_smooth` (:813; SIFT's scale space on a grid
// octave), kernel K the big-Q branch of `grid_radius_neighbors` (:507, its
// two-stage top-k at :534-560; SIFT's 26-NN on a grid octave). Their plain
// PyTorch versions are kernels/grid.py: nn_query_ref, moments_ref,
// count_ref, smooth_ref and knn_ref, which run core/grid.grid_query's chunks
// of (bucket, 27 x cap) distance planes.
//
// What they compute. A query slot s of bucket b of the query grid (q_ok set)
// is swept against its candidates: the filled slots (slot < count) of the
// distinct wrapped neighbour buckets of b, in ascending bucket id, then slot
// order: core/grid._candidates' order with its empty slots and its wrapped
// duplicates left out, which it masks. A candidate p is a member when
// d2 <= r2, d2 = ((qx - px)^2 + (qy - py)^2) + (qz - pz)^2 through
// __fsub_rn / __fmul_rn / __fadd_rn (cull.cuh: sq_dist), bit for bit
// core/grid._d2. Each query writes its row (the slot's point index) and no
// other; the wrapper fills the other rows with the plain version's defaults.
// - G (mm_grid_nn): the smallest member d2 and the point index of its first
//   candidate position (strict <, as argmin takes the first minimum); a
//   query with no member gets d2 = BIG and the index of the first candidate
//   position, cell_idx[smallest neighbour id, 0]: what argmin over a row of
//   BIG returns. An index >= n_p (an empty slot) becomes 0. Bit for bit.
// - H (mm_grid_moments): of the query-centred offsets r = p - q of the
//   members, the count, sum r and sum r_i r_j (each product rounded once),
//   summed in candidate order, then the plain version's epilogue: denom =
//   max(count, 1), m = s1 / denom, cov = s2 / denom - m_i m_j, mean = m + q.
//   The plain version sums by torch's reduction tree, so the two agree to
//   rounding (kernels/grid.py states the tolerance); the count is exact, and
//   a launch repeats bit for bit.
// - I (mm_grid_count): the member count, minus `sub` (1 where the caller
//   excludes the query itself). Bit for bit.
// - J (mm_grid_smooth): for each sigma, num / max(den, 1e-12) with num =
//   sum w v and den = sum w over the members, w = expf(-d2 * c), c the
//   float32 value of 1 / (2 s^2) (the plain version's constant), v the
//   candidate's value, staged beside its coordinates from the cell-layout
//   gather of the values that grid_query makes (the wrapper makes it). C's
//   arithmetic (csrc/sift.cu: __fmul_rn, expf, __fadd_rn in candidate
//   order, __fdiv_rn); the plain version's bmm and row sum add in another
//   order, so the two agree to rounding (kernels/grid.py states the
//   tolerance), and a launch repeats bit for bit. A CTA takes kSigLane
//   sigmas, blockIdx.y the group.
// - K (mm_grid_knn): the k <= 26 smallest d2 over every candidate (no
//   radius cut in the selection), ties to the first candidate position, then
//   valid = d2 <= r2; with `exclude`, a candidate at d2 <= 1e-12 goes to BIG.
//   An entry at BIG or beyond (a short list's padding, an excluded point, a
//   candidate >= BIG away: the candidates of a query parked at FAR) is (0,
//   BIG, BIG <= r2), else (its point index, d2, d2 <= r2). The plain
//   version sorts stably and applies the same rule, so K is bit for bit.
//
// What bounds them. Each (query, candidate) pair costs the distance and a
// compare (9 operations) on the CUDA cores, J 5 more a sigma for a member;
// the plain version spends ~10 launches and a (37, 256, 6,912)-float plane
// of device memory traffic per 37 buckets (K a stable sort of it). Here one
// CTA takes one query bucket (a bucket with no query exits at once, so no
// host read picks the buckets), one thread one query slot. The CTA stages
// its candidates, kChunk slots at a time, into shared memory through a
// cp.async double buffer (4-byte copies: the (H, C, 3) layout is not
// float4-aligned; J's value in w) while it scans the chunk before; every
// thread scans the staged chunk in candidate order, so ties and sums need
// no merge. K keeps each thread's list of (d2, position) in shared memory,
// a column per thread (128 x 26 x 8 B), and rejects a candidate against the
// list's k-th at once; candidates arrive in position order, so an insertion
// goes after every entry of equal d2 and a strict < gives the first
// position on ties. A cap above the CTA's threads takes the query slots in
// groups. No FMA contraction (-fmad=false), no atomics, no fast-math.

#include "cull.cuh"

namespace {

constexpr int kNbr = 27;           // neighbour buckets of a bucket
constexpr int kChunk = 256;        // candidate slots a stage
constexpr int kNnThreads = 256;     // G: a thread a query slot up to cap 256
constexpr int kRadiusThreads = 128; // H-K: up to cap 128 (larger caps in groups)
constexpr float kBig = 1.0e12f;    // core/grid.py BIG
constexpr int kSigLane = 8;        // J: sigmas a CTA takes (blockIdx.y the group)
constexpr int kMaxSigma = 64;      // J: sigmas a launch takes
constexpr int kK = 26;             // K: the longest list

// The distinct wrapped neighbour buckets of one bucket, ascending, and the
// flat candidate position of each one's first filled slot: candidate
// position j lies in bucket id[k] for start[k] <= j < start[k + 1], and
// start[n] (and every start past it) is the number of candidates.
struct Nbrs {
  int id[32];
  int start[32];
  int n;
};

// Warp 0, all lanes: the sorted distinct neighbours of bucket b (lane l the
// offset _OFFSETS[l], x fastest; on an axis of 1 or 2 cells ids repeat and
// the first copy is kept) and the exclusive scan of their filled counts.
__device__ __forceinline__ void neighbours(Nbrs& nb, int b, int gx, int gy, int gz,
                                           const int* __restrict__ count, int lane) {
  const int bx = b % gx, by = (b / gx) % gy, bz = b / (gx * gy);
  int id = INT_MAX;
  if (lane < kNbr) {
    const int nx = (bx + lane % 3 - 1 + gx) % gx;
    const int ny = (by + (lane / 3) % 3 - 1 + gy) % gy;
    const int nz = (bz + lane / 9 - 1 + gz) % gz;
    id = (nz * gy + ny) * gx + nx;
  }
  bool dup = false;
  for (int k = 0; k < kNbr; ++k) {
    const int other = __shfl_sync(kAll, id, k);  // every lane shuffles
    dup |= k < lane && other == id;
  }
  const bool first = lane < kNbr && !dup;
  const unsigned keep = __ballot_sync(kAll, first);
  int rank = 0;  // distinct ids below mine
  for (int k = 0; k < kNbr; ++k) {
    const int other = __shfl_sync(kAll, id, k);
    rank += ((keep >> k) & 1u) && other < id;
  }
  if (first) nb.id[rank] = id;
  __syncwarp();
  const int n = __popc(keep);
  const int cnt = lane < n ? count[nb.id[lane]] : 0;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += v;
  }
  nb.start[lane] = incl - cnt;
  if (lane == 0) nb.n = n;
}

// the target grid slot of candidate position j (j < the candidate count),
// k a hint at or below its bucket's rank, advanced
__device__ __forceinline__ long long slot_of(const Nbrs& nb, int j, int& k, int cap) {
  while (nb.start[k + 1] <= j) ++k;
  return static_cast<long long>(nb.id[k]) * cap + (j - nb.start[k]);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Kernel G's per-query state and its steps.
struct NnOp {
  const long long* t_idx;  // target cell_idx (H, cap)
  int n_p;
  int* idx_out;
  float* d2_out;

  struct State {
    float best;
    int pos;  // first candidate position of best; -1 for none
  };
  __device__ __forceinline__ State init() const { return {kBig, -1}; }
  __device__ __forceinline__ void visit(State& s, float qx, float qy, float qz, float4 p,
                                        int pos, float r2) const {
    const float d2 = sq_dist(qx, qy, qz, p.x, p.y, p.z);
    if (d2 <= r2 && d2 < s.best) {
      s.best = d2;
      s.pos = pos;
    }
  }
  __device__ __forceinline__ void write(const State& s, long long row, float, float, float,
                                        const Nbrs& nb, int cap) const {
    int k = 0;
    const long long g = s.pos < 0 ? static_cast<long long>(nb.id[0]) * cap
                                  : slot_of(nb, s.pos, k, cap);
    const long long r = t_idx[g];
    idx_out[row] = r >= n_p ? 0 : static_cast<int>(r);
    d2_out[row] = s.best;
  }
};

// Kernel H's.
struct MomentsOp {
  float* s0_out;    // (nq,)
  float* mean_out;  // (nq, 3)
  float* cov_out;   // (nq, 3, 3)

  struct State {
    float n, x, y, z, xx, xy, xz, yy, yz, zz;
  };
  __device__ __forceinline__ State init() const {
    return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  __device__ __forceinline__ void visit(State& s, float qx, float qy, float qz, float4 p,
                                        int, float r2) const {
    const float rx = __fsub_rn(p.x, qx);
    const float ry = __fsub_rn(p.y, qy);
    const float rz = __fsub_rn(p.z, qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                               __fmul_rn(rz, rz));
    if (d2 <= r2) {
      s.n = __fadd_rn(s.n, 1.f);
      s.x = __fadd_rn(s.x, rx);
      s.y = __fadd_rn(s.y, ry);
      s.z = __fadd_rn(s.z, rz);
      s.xx = __fadd_rn(s.xx, __fmul_rn(rx, rx));
      s.xy = __fadd_rn(s.xy, __fmul_rn(rx, ry));
      s.xz = __fadd_rn(s.xz, __fmul_rn(rx, rz));
      s.yy = __fadd_rn(s.yy, __fmul_rn(ry, ry));
      s.yz = __fadd_rn(s.yz, __fmul_rn(ry, rz));
      s.zz = __fadd_rn(s.zz, __fmul_rn(rz, rz));
    }
  }
  __device__ __forceinline__ void write(const State& s, long long row, float qx, float qy,
                                        float qz, const Nbrs&, int) const {
    const float denom = fmaxf(s.n, 1.f);
    const float m[3] = {__fdiv_rn(s.x, denom), __fdiv_rn(s.y, denom),
                        __fdiv_rn(s.z, denom)};
    const float s2[9] = {s.xx, s.xy, s.xz, s.xy, s.yy, s.yz, s.xz, s.yz, s.zz};
    s0_out[row] = s.n;
    mean_out[3 * row] = __fadd_rn(m[0], qx);
    mean_out[3 * row + 1] = __fadd_rn(m[1], qy);
    mean_out[3 * row + 2] = __fadd_rn(m[2], qz);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cov_out[9 * row + 3 * i + j] =
            __fsub_rn(__fdiv_rn(s2[3 * i + j], denom), __fmul_rn(m[i], m[j]));
      }
    }
  }
};

// Kernel I's.
struct CountOp {
  int sub;
  int* out;

  using State = int;
  __device__ __forceinline__ State init() const { return 0; }
  __device__ __forceinline__ void visit(State& s, float qx, float qy, float qz, float4 p,
                                        int, float r2) const {
    s += sq_dist(qx, qy, qz, p.x, p.y, p.z) <= r2;
  }
  __device__ __forceinline__ void write(const State& s, long long row, float, float, float,
                                        const Nbrs&, int) const {
    out[row] = s - sub;
  }
};

// Kernel J's: the sigmas s0 = blockIdx.y * kSigLane on of this CTA's group.
struct Recips {
  float v[kMaxSigma];  // f32(1 / (2 s^2)) of each sigma
};

struct SmoothOp {
  Recips recips;
  int n_sigma;
  float* out;  // (nq, n_sigma)

  struct State {
    float rc[kSigLane], num[kSigLane], den[kSigLane];
  };
  __device__ __forceinline__ State init() const {
    State s;
    const int s0 = blockIdx.y * kSigLane;
#pragma unroll
    for (int i = 0; i < kSigLane; ++i) {
      s.rc[i] = s0 + i < n_sigma ? recips.v[s0 + i] : 0.f;
      s.num[i] = s.den[i] = 0.f;
    }
    return s;
  }
  __device__ __forceinline__ void visit(State& s, float qx, float qy, float qz, float4 p,
                                        int, float r2) const {
    const float d2 = sq_dist(qx, qy, qz, p.x, p.y, p.z);
    if (d2 <= r2) {
      const float neg = -d2;
      const int s0 = blockIdx.y * kSigLane;
#pragma unroll
      for (int i = 0; i < kSigLane; ++i) {
        if (s0 + i < n_sigma) {
          const float w = expf(__fmul_rn(neg, s.rc[i]));
          s.num[i] = __fadd_rn(s.num[i], __fmul_rn(w, p.w));
          s.den[i] = __fadd_rn(s.den[i], w);
        }
      }
    }
  }
  __device__ __forceinline__ void write(const State& s, long long row, float, float, float,
                                        const Nbrs&, int) const {
    const int s0 = blockIdx.y * kSigLane;
#pragma unroll
    for (int i = 0; i < kSigLane; ++i) {
      if (s0 + i < n_sigma) {
        out[row * n_sigma + s0 + i] = __fdiv_rn(s.num[i], fmaxf(s.den[i], 1e-12f));
      }
    }
  }
};

// Kernel K's lists: column t the sorted (d2, candidate position) list of
// thread t, kRadiusThreads x kK x 8 B of the CTA's shared memory.
struct KnnLists {
  float d2[kK][kRadiusThreads];
  int pos[kK][kRadiusThreads];  // -1: padding at BIG
};

__device__ __forceinline__ KnnLists& knn_lists() {
  __shared__ KnnLists lists;
  return lists;
}

// Kernel K's.
struct KnnOp {
  const long long* t_idx;  // target cell_idx (H, cap)
  int n_p;
  int k;
  int exclude;  // exclude_self: d2 <= 1e-12 goes to BIG
  float r2;     // valid = d2 <= r2
  int* idx_out;            // (nq, k)
  float* d2_out;           // (nq, k)
  unsigned char* valid_out;  // (nq, k)

  struct State {
    float last;  // the list's k-th d2: BIG until k candidates entered
  };
  __device__ __forceinline__ State init() const {
    KnnLists& l = knn_lists();
    const int t = threadIdx.x;
    for (int i = 0; i < k; ++i) {
      l.d2[i][t] = kBig;
      l.pos[i][t] = -1;
    }
    return {kBig};
  }
  // Candidates come in position order, so every entry of the list has a
  // lower position than `pos`: it goes after the entries of equal d2
  // (strict <), and one at or past the k-th (BIG included) never enters.
  __device__ __forceinline__ void visit(State& s, float qx, float qy, float qz, float4 p,
                                        int pos, float) const {
    const float d2 = sq_dist(qx, qy, qz, p.x, p.y, p.z);
    if (!(d2 < s.last) || (exclude && d2 <= 1e-12f)) return;
    KnnLists& l = knn_lists();
    const int t = threadIdx.x;
    int j = k - 1;
    while (j > 0 && d2 < l.d2[j - 1][t]) {
      l.d2[j][t] = l.d2[j - 1][t];
      l.pos[j][t] = l.pos[j - 1][t];
      --j;
    }
    l.d2[j][t] = d2;
    l.pos[j][t] = pos;
    s.last = l.d2[k - 1][t];
  }
  __device__ __forceinline__ void write(const State&, long long row, float, float, float,
                                        const Nbrs& nb, int cap) const {
    const KnnLists& l = knn_lists();
    const int t = threadIdx.x;
    for (int i = 0; i < k; ++i) {
      const float d = l.d2[i][t];
      const int pos = l.pos[i][t];
      int r = 0;
      if (pos >= 0) {
        int hint = 0;
        const long long g = t_idx[slot_of(nb, pos, hint, cap)];
        r = g >= n_p ? 0 : static_cast<int>(g);
      }
      idx_out[row * k + i] = r;
      d2_out[row * k + i] = d;
      valid_out[row * k + i] = d <= r2;
    }
  }
};

// One CTA a query bucket: its query slots (in groups of blockDim.x) against
// the candidates of its distinct neighbour buckets, staged kChunk at a time
// (their values in w where t_val is given: J).
template <class Op>
__global__ void __launch_bounds__(kNnThreads)
grid_sweep_kernel(const float* __restrict__ t_xyz, const float* __restrict__ t_val,
                  const int* __restrict__ t_count,
                  const float* __restrict__ q_xyz, const long long* __restrict__ q_idx,
                  const unsigned char* __restrict__ q_ok, const int* __restrict__ q_count,
                  int cap, int gx, int gy, int gz, float r2, Op op) {
  __shared__ Nbrs nb;
  __shared__ float4 stage[2][kChunk];

  const int b = blockIdx.x;
  if (q_count[b] == 0) return;  // CTA-uniform: no query slot here
  const int tid = threadIdx.x;
  if (tid < 32) neighbours(nb, b, gx, gy, gz, t_count, tid);
  __syncthreads();
  const int total = nb.start[nb.n];
  const int chunks = (total + kChunk - 1) / kChunk;
  const long long base = static_cast<long long>(b) * cap;

  for (int g0 = 0; g0 < cap; g0 += blockDim.x) {
    const int s = g0 + tid;
    const bool ok = s < cap && q_ok[base + s];
    if (!__syncthreads_or(ok)) continue;  // CTA-uniform
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (ok) {
      qx = q_xyz[3 * (base + s)];
      qy = q_xyz[3 * (base + s) + 1];
      qz = q_xyz[3 * (base + s) + 2];
    }
    typename Op::State st = op.init();

    int hint = 0;  // this thread's staged positions only grow
    auto issue = [&](int c) {
      float4* dst = stage[c & 1];
      const int p0 = c * kChunk, n = min(kChunk, total - p0);
      for (int j = tid; j < n; j += blockDim.x) {
        const long long slot = slot_of(nb, p0 + j, hint, cap);
        const float* src = t_xyz + 3 * slot;
        cp_async4(&dst[j].x, src);
        cp_async4(&dst[j].y, src + 1);
        cp_async4(&dst[j].z, src + 2);
        if (t_val != nullptr) cp_async4(&dst[j].w, t_val + slot);
      }
    };
    if (chunks > 0) issue(0);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) issue(c + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk c, this thread's copies
      __syncthreads();     // and everyone's
      if (ok) {
        const float4* pts = stage[c & 1];
        const int p0 = c * kChunk, n = min(kChunk, total - p0);
        for (int i = 0; i < n; ++i) op.visit(st, qx, qy, qz, pts[i], p0 + i, r2);
      }
      __syncthreads();  // the buffer is refilled next
    }
    if (ok) op.write(st, q_idx[base + s], qx, qy, qz, nb, cap);
  }
}

template <class Op>
int launch(const float* t_xyz, const float* t_val, const int* t_count, const float* q_xyz,
           const long long* q_idx, const unsigned char* q_ok, const int* q_count, int h,
           int cap, int gx, int gy, int gz, float r2, int groups, int max_threads, Op op,
           void* stream) {
  if (h < 1 || cap < 1 || gx < 1 || gy < 1 || gz < 1 ||
      static_cast<long long>(gx) * gy * gz != h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fit = (cap + 31) / 32 * 32;
  const int threads = fit < max_threads ? fit : max_threads;
  const dim3 grid(static_cast<unsigned>(h), static_cast<unsigned>(groups));
  grid_sweep_kernel<Op><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      t_xyz, t_val, t_count, q_xyz, q_idx, q_ok, q_count, cap, gx, gy, gz, r2, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grids of core/grid.py:build_grid, both of h = gx gy gz buckets of cap
// slots: the target's t_xyz (h, cap, 3) f32, t_idx (h, cap) i64 (G and K)
// and t_count (h,) i32 (slots [0, count) are filled); the query grid's q_xyz
// (h, cap, 3) f32, q_idx (h, cap) i64 (the output row of each slot), q_ok
// (h, cap) bool (the slots to answer) and q_count (h,) i32 (0 where a bucket
// has no slot to answer). r2 the float32 squared radius (K: of `valid`).
// Each returns cudaGetLastError() after its one launch.

// Kernel G: idx_out (nq,) i32, d2_out (nq,) f32 at the answered rows.
extern "C" int mm_grid_nn(const float* t_xyz, const long long* t_idx, const int* t_count,
                          const float* q_xyz, const long long* q_idx,
                          const unsigned char* q_ok, const int* q_count, int h, int cap,
                          int gx, int gy, int gz, float r2, int n_p, int* idx_out,
                          float* d2_out, void* stream) {
  return launch(t_xyz, nullptr, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz,
                r2, 1, kNnThreads, NnOp{t_idx, n_p, idx_out, d2_out}, stream);
}

// Kernel H: s0_out (nq,), mean_out (nq, 3), cov_out (nq, 3, 3) f32 at the
// answered rows.
extern "C" int mm_grid_moments(const float* t_xyz, const int* t_count, const float* q_xyz,
                               const long long* q_idx, const unsigned char* q_ok,
                               const int* q_count, int h, int cap, int gx, int gy, int gz,
                               float r2, float* s0_out, float* mean_out, float* cov_out,
                               void* stream) {
  return launch(t_xyz, nullptr, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz,
                r2, 1, kRadiusThreads, MomentsOp{s0_out, mean_out, cov_out}, stream);
}

// Kernel I: out (nq,) i32 at the answered rows, the member count minus sub.
extern "C" int mm_grid_count(const float* t_xyz, const int* t_count, const float* q_xyz,
                             const long long* q_idx, const unsigned char* q_ok,
                             const int* q_count, int h, int cap, int gx, int gy, int gz,
                             float r2, int sub, int* out, void* stream) {
  return launch(t_xyz, nullptr, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz,
                r2, 1, kRadiusThreads, CountOp{sub, out}, stream);
}

// Kernel J: t_val (h, cap) f32, the targets' values in the grid's layout
// (the gather of grid_query's p_values); recips (n_sigma <= 64,) f32 in host
// memory, f32(1 / (2 s^2)) of each sigma, passed by value; out (nq,
// n_sigma) f32 at the answered rows.
extern "C" int mm_grid_smooth(const float* t_xyz, const float* t_val, const int* t_count,
                              const float* q_xyz, const long long* q_idx,
                              const unsigned char* q_ok, const int* q_count, int h, int cap,
                              int gx, int gy, int gz, float r2, const float* recips,
                              int n_sigma, float* out, void* stream) {
  if (n_sigma < 1 || n_sigma > kMaxSigma || t_val == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmoothOp op{};
  for (int s = 0; s < n_sigma; ++s) op.recips.v[s] = recips[s];
  op.n_sigma = n_sigma;
  op.out = out;
  return launch(t_xyz, t_val, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz, r2,
                (n_sigma + kSigLane - 1) / kSigLane, kRadiusThreads, op, stream);
}

// Kernel K: 1 <= k <= 26; exclude_self 0 or 1; idx_out (nq, k) i32, d2_out
// (nq, k) f32, valid_out (nq, k) bool at the answered rows.
extern "C" int mm_grid_knn(const float* t_xyz, const long long* t_idx, const int* t_count,
                           const float* q_xyz, const long long* q_idx,
                           const unsigned char* q_ok, const int* q_count, int h, int cap,
                           int gx, int gy, int gz, float r2, int k, int exclude_self, int n_p,
                           int* idx_out, float* d2_out, unsigned char* valid_out,
                           void* stream) {
  if (k < 1 || k > kK) return static_cast<int>(cudaErrorInvalidValue);
  return launch(t_xyz, nullptr, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz,
                r2, 1, kRadiusThreads,
                KnnOp{t_idx, n_p, k, exclude_self, r2, idx_out, d2_out, valid_out}, stream);
}
