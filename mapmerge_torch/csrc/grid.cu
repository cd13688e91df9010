// The cell-grid engine's sweeps for Hopper (sm_90a): the bounded 1-NN
// (kernel G), the radius moments (kernel H), the radius count (kernel I),
// SIFT's Gaussian scale space (kernel J), its k nearest neighbours (kernel
// K) and the radius reduce (kernel L) of every query slot of a query grid
// against the points of a target grid, both grids read in place
// (core/grid.py: build_grid); L also answers a few queries with no query
// grid.
//
// None replaces a Pallas kernel: the JAX package leaves all six to XLA,
// through mapmerge_tpu/ops/grid.py `grid_query`. Kernel G replaces
// `grid_nn_query` (:594; ICP every iteration, and the transform score through
// `grid_nearest_neighbor`), kernel H `grid_neighbor_moments` (:754; the
// surface normals), kernel I `grid_radius_count` (:397; outlier removal),
// kernel J `grid_gaussian_smooth` (:813; SIFT's scale space on a grid
// octave), kernel K the big-Q branch of `grid_radius_neighbors` (:507, its
// two-stage top-k at :534-560; SIFT's 26-NN on a grid octave), kernel L
// `grid_radius_reduce` (:701; Harris's response and non-max suppression,
// its big-Q branch :721-740, and its corner refinement, the small-Q path
// `_radius_reduce_smallq` :632). Their plain PyTorch versions are
// kernels/grid.py: nn_query_ref, moments_ref, count_ref, smooth_ref,
// knn_ref and reduce_ref, which run core/grid.grid_query's chunks of
// (bucket, 27 x cap) distance planes, and reduce_list_ref, the small-Q
// gather of each query's 27 neighbour blocks.
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
//   member's value, read in place through the target's cell_idx
//   (values[cell_idx[slot]], filled slots only). C's arithmetic (csrc/sift.cu: __fmul_rn, expf, __fadd_rn in candidate
//   order, __fdiv_rn); the plain version's bmm and row sum add in another
//   order, so the two agree to rounding (kernels/grid.py states the
//   tolerance), and a launch repeats bit for bit. A warp takes kSigLane
//   sigmas, blockIdx.y the group, so 64 sigmas take 8 groups.
// - K (mm_grid_knn): the k <= 26 smallest d2 over every candidate (no
//   radius cut in the selection), ties to the first candidate position, then
//   valid = d2 <= r2; with `exclude`, a candidate at d2 <= 1e-12 goes to BIG.
//   An entry at BIG or beyond (a short list's padding, an excluded point, a
//   candidate >= BIG away: the candidates of a query parked at FAR) is (0,
//   BIG, BIG <= r2), else (its point index, d2, d2 <= r2). The plain
//   version sorts stably and applies the same rule, so K is bit for bit.
// - L (mm_grid_reduce, mm_grid_reduce_list): the member count, and per
//   channel of the members' values (P, C <= 16), read in place through the
//   target's cell_idx, their sum (__fadd_rn) or their max, a NaN kept as
//   amax keeps it; where a query has fewer members than its 27 cap
//   candidate positions the max also meets the plain version's -BIG of a
//   non-member. The count and the max are bit for bit; the sum adds the
//   same terms as the plain version's bmm in another order (the sweep
//   route in candidate order, each channel on its own, so a channel's sum
//   does not depend on C; the list route a lane's slots in order, then a
//   fixed shuffle tree), so the two agree to rounding (kernels/grid.py
//   states the tolerance), and a launch repeats bit for bit. A non-member's
//   value is never read: the plain bmm's 0 x v of a non-member with a NaN
//   value has no counterpart.
//
// What bounds them. Each (query, candidate) pair costs the distance and a
// compare (9 operations) on the CUDA cores, H 16 more for a member and J 5
// more a sigma; the plain version spends ~10 launches and a (37, 256,
// 6,912)-float plane of device memory traffic per 37 buckets (K a stable
// sort of it). A sweep that compares every candidate is bound by latency,
// not issue: a query's candidates are one dependent chain.
//
// G and K (grid_select_kernel) need only the first member, or the first k
// candidates, of each query, so they cull, exactly, as kernel D does
// (csrc/sift.cu; cull.cuh's box bound and lists):
// 1. A pre-pass (grid_pack_kernel, its own launch, with nothing zeroed
//    before it) writes the box of every run of kT = 32 consecutive slots of
//    each target bucket (a tile), a thread a tile. Slots lie in
//    build_grid's stable order, so a run is compact in space; the box comes
//    from the points, not from the bucket's cell, which wraps. The tiles
//    themselves are read in place: kT slots of (x, y, z) are 384 bytes,
//    16-byte aligned where cap % 4 == 0, so the ring copies them 16 bytes a
//    lane with no float4 copy of the grid. A caller that queries one target
//    grid many times (ICP) has the boxes made once and passes them back
//    (boxes_ready). The same launch lists the units of the query grid:
//    groups of up to 32 answered slots of one bucket, the count first
//    (runs of 1,024 buckets placed by an atomic ticket that the launch's
//    last CTA returns to 0), so a grid of warps takes them with no host
//    read.
// 2. A unit sweeps its bucket's own tiles first, then the other distinct
//    neighbours' tiles nearest first from the box of its queries. A tile is
//    visited when its box bound (q clamped into the box, then sq_dist in
//    the same rounded operations: <= the kernel's own d2 of every point in
//    the box, with no epsilon) comes, paired with the tile's first slot,
//    before some query's threshold in (d2, slot) order, and checked again
//    when it arrives; the sweep stops where the next tile's bound from the
//    queries' box lies past the loosest threshold. Slot order is candidate
//    order (the neighbours are ascending), and every point of a tile comes
//    at or after (bound, first slot), so a skipped tile holds nothing that
//    could displace an answer, whatever the order of the visits: ties still
//    go to the first candidate position. G's threshold is its best member
//    so far within r2, K's its 26th; nearest first, they tighten early.
// 3. One lane a query: a warp is full but for a bucket's last unit. G keeps
//    the first (d2, slot) member, K a sorted list of kK in registers
//    (cull.cuh's insert). (2, 4 and 8 lanes a query, their lists merged at
//    the end, compared fewer pairs and were slower on the main paths'
//    inputs: PERF.md.)
//
// H and J (grid_radius_kernel) add only members, a member being a point
// within the fixed radius r2, so they cull too, on the same pre-pass and
// units, and keep the sweep's bits:
// 1. A warp takes one unit (the grid covers the longest unit list, so the
//    card's block scheduler balances units of unequal work) and walks the
//    tiles of its bucket's distinct neighbours in candidate order
//    (ascending neighbour id, then tile, then slot), 32 positions at a
//    time; a tile is issued into the ring when its box lies within r2 of
//    the box of the unit's queries (cull.cuh's boxes_bound).
// 2. When it arrives the tile is rewritten as float4 points, and each lane
//    whose own query's bound (box_bound, the same rounded operations as
//    the distance, <= every point's d2 in the box; H's offset p - q
//    squares to the same bits as q - p) is within r2 adds its members in
//    slot order: H as it meets them, J after marking them, so that the
//    weights are made for its own members only. A tile skipped by either
//    test holds no member of the lane, and a non-member adds nothing, so
//    every lane sums exactly the sweep's terms in the sweep's order: H and
//    J are the bits of the one-thread-a-slot sweep they replace.
// 3. One lane a query, its sums in registers (H its ten, J num and den of
//    kSigLane sigmas). J reads each staged tile's point indices (cell_idx,
//    8-byte copies beside the tile) and, on arrival, each slot's value
//    through them into shared memory, so no (h, cap) plane of values is
//    made.
// What bounds H and J is each query's chain of members, added in order:
// a box test culls only non-members, and the tiles span most of a cell,
// whose edge is the radius (PERF.md).
//
// I (grid_count_kernel) adds one integer a member: exact in any order, so
// it needs neither the sweep's order nor a lane a query at the compare.
// 1. A warp takes one unit and walks its tiles as H and J do (the
//    pre-pass's units and boxes; a tile is issued when its box lies within
//    r2 of the box of the unit's queries).
// 2. When a tile arrives each lane bounds its own query against the box
//    (box_bound): beyond r2, the query takes nothing there; within, it
//    straddles the radius. (A query whose far bound, the box's farthest
//    corner, lies within r2 could take the tile's count whole; that saved
//    7-9% of the compared pairs and no time on the card: PERF.md.)
// 3. Where the tile's straddling queries are few against its filled
//    slots, the warp takes one step a straddling query with its lanes on
//    the tile's slots: the query read by every lane, each lane's slot
//    tested (sq_dist <= r2, the plain version's d2), the ballot's popcount
//    added by the query's lane; a tile then costs a step a straddling
//    query, where H's loop costs the tile's filled slots whatever the
//    ballot. Where they are many, each straddling lane loops over the
//    slots, which costs less a pair than a step (PERF.md).
// L's sum on the sweep route (grid_radius_kernel with ReduceOp) is H's: the
// same pre-pass, units, walk and box tests, each lane adding its members in
// slot order; a tile's C values a slot are loaded, through its staged point
// indices, into registers before the members are marked and into shared
// memory after. L's max on the sweep route (grid_max_kernel) is I's: a max
// is exact in any order, so a tile's straddling queries are maxed a step a
// query with the lanes on the slots (a warp max of an order-preserving
// integer key of each member's value) or a lane a query over the slots, as
// kLoopTenths decides. Both are instantiated for the widths on the paths (C
// = 1, 6 and 9, their arrays, registers and scratch that wide) and once for
// any C up to 16. L's list route (grid_reduce_list_kernel, at most 4,096
// queries: Harris's refinement) needs no query grid and drops no query: a
// warp a query, its lanes over the filled slots of the query's distinct
// neighbours, a tile of 32 slots skipped where its box (the pre-pass's)
// lies beyond the radius of the query.
// What bounds L's sum is H's chain of members a query, each adding C values
// where H adds ten sums; the values are read once a visited tile.
// No FMA contraction (-fmad=false), no fast-math; the pre-pass's atomics
// only hand out where a run of units goes and count its unit CTAs done.

#include "cull.cuh"

namespace {

constexpr int kNbr = 27;           // neighbour buckets of a bucket
constexpr float kBig = 1.0e12f;    // core/grid.py BIG
constexpr int kSigLane = 8;        // J: sigmas a warp takes (blockIdx.y the group)
constexpr int kMaxSigma = 64;      // J: sigmas a launch takes
constexpr int kK = 26;             // K: the longest list (and every lane's)

// One target tile in shared memory: kT consecutive slots of a bucket as
// the grid holds them, (x, y, z) a slot, its box, its first global slot
// (bucket * cap + tile * kT: the candidate order's key) and its filled
// slots.
struct alignas(16) GridStage {
  float pt[3 * kT];
  float4 lo, hi;
  int g0, n, pad0, pad1;
};

// Kernel J's stage: a tile and the target point index (cell_idx) of each
// of its slots, through which the tile's values are read when it is
// consumed.
struct alignas(16) ValStage : GridStage {
  long long idx[kT];
};

// A warp, all lanes: the sorted distinct wrapped neighbours of bucket b
// into ids[0, n) (lane l the offset _OFFSETS[l], x fastest; on an axis of
// 1 or 2 cells ids repeat and the first copy is kept); returns n.
__device__ __forceinline__ int neighbour_ids(int* ids, int b, int gx, int gy, int gz,
                                             int lane) {
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
  if (first) ids[rank] = id;
  __syncwarp();
  return __popc(keep);
}

// the inclusive sum of v over lanes 0..lane (every lane of the warp)
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Kernel H's. A member of query q is a target point p whose offset r = p - q
// has ((rx^2 + ry^2) + rz^2) <= r2; `tile` adds a staged tile's members in
// slot order.
struct MomentsOp {
  static constexpr bool kValues = false;
  using Stage = GridStage;
  struct Scratch {};
  float* s0_out;    // (nq,)
  float* mean_out;  // (nq, 3)
  float* cov_out;   // (nq, 3, 3)

  struct State {
    float n, x, y, z, xx, xy, xz, yy, yz, zz;
  };
  __device__ __forceinline__ State init() const {
    return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  __device__ __forceinline__ float value(const Stage&, int) const { return 0.f; }
  // this lane's members among the tile's n points (where `reach`), in slot
  // order; returns how many
  __device__ __forceinline__ int tile(State& s, float qx, float qy, float qz, bool reach,
                                      const float4* pt, int n, float, Scratch&, int,
                                      float r2) const {
    int added = 0;
    if (!reach) return added;
    for (int j = 0; j < n; ++j) {
      const float4 p = pt[j];
      const float rx = __fsub_rn(p.x, qx);
      const float ry = __fsub_rn(p.y, qy);
      const float rz = __fsub_rn(p.z, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                                 __fmul_rn(rz, rz));
      if (d2 <= r2) {
        ++added;
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
    return added;
  }
  __device__ __forceinline__ void write(const State& s, long long row, float qx, float qy,
                                        float qz) const {
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

// Kernel J's: the sigmas s0 = blockIdx.y * kSigLane on of this CTA's group.
// A member is a target point within r2 (sq_dist) and adds w v and w at each
// sigma, v its value, read through the target's cell_idx (ValStage).
struct Recips {
  float v[kMaxSigma];  // f32(1 / (2 s^2)) of each sigma
};

// the values of the tile being consumed, a slot each
struct SmoothScratch {
  float val[kT];
};

struct SmoothOp {
  static constexpr bool kValues = true;
  using Stage = ValStage;
  using Scratch = SmoothScratch;
  Recips recips;
  int n_sigma;
  const float* values;  // (P,): the value of each target point
  float* out;           // (nq, n_sigma)

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
  // the value of slot `lane` of the staged tile (0 past its filled slots)
  __device__ __forceinline__ float value(const Stage& st, int lane) const {
    return lane < st.n ? __ldg(values + st.idx[lane]) : 0.f;
  }
  // The warp, all lanes: this lane's members among the tile's n points
  // (where `reach`; v the value of slot `lane`), marked first, then added
  // in slot order, each lane as many as its own (the weights, the costly
  // part, only for members). Returns how many.
  __device__ __forceinline__ int tile(State& s, float qx, float qy, float qz, bool reach,
                                      const float4* pt, int n, float v, Scratch& x, int lane,
                                      float r2) const {
    unsigned m = 0;
    if (reach) {
      for (int j = 0; j < n; ++j) {
        m |= static_cast<unsigned>(sq_dist(qx, qy, qz, pt[j].x, pt[j].y, pt[j].z) <= r2) << j;
      }
    }
    x.val[lane] = v;
    __syncwarp();
    const int added = __popc(m);
    const int s0 = blockIdx.y * kSigLane;
    while (m != 0) {
      const int j = __ffs(static_cast<int>(m)) - 1;
      m &= m - 1;
      const float neg = -sq_dist(qx, qy, qz, pt[j].x, pt[j].y, pt[j].z);
      const float vj = x.val[j];
#pragma unroll
      for (int i = 0; i < kSigLane; ++i) {
        if (s0 + i < n_sigma) {
          const float w = expf(__fmul_rn(neg, s.rc[i]));
          s.num[i] = __fadd_rn(s.num[i], __fmul_rn(w, vj));
          s.den[i] = __fadd_rn(s.den[i], w);
        }
      }
    }
    return added;
  }
  __device__ __forceinline__ void write(const State& s, long long row, float, float,
                                        float) const {
    const int s0 = blockIdx.y * kSigLane;
#pragma unroll
    for (int i = 0; i < kSigLane; ++i) {
      if (s0 + i < n_sigma) {
        out[row * n_sigma + s0 + i] = __fdiv_rn(s.num[i], fmaxf(s.den[i], 1e-12f));
      }
    }
  }
};

// Kernel L's sweep route for the sum: the count and the sum of each
// member's values, read in place through the target's cell_idx (ValStage),
// a member being a target point within r2 (sq_dist, the plain version's
// d2). The width is fixed at compile time where kC > 0 (1, 6 or 9: the
// widths on the paths), so C = 1 carries one float a lane; kC = 0 takes any
// C <= kMaxChannels at run time, its arrays kMaxChannels wide. The max has
// a kernel of its own (grid_max_kernel).
constexpr int kMaxChannels = 16;  // L: the widest value row a launch takes

// the arrays' width of a kernel of width kC (0: any, up to kMaxChannels)
template <int kC>
constexpr int kWidth = kC > 0 ? kC : kMaxChannels;

// the larger of a and b, NaN where either is NaN (amax's rule; fmaxf drops
// a NaN): one max.NaN.f32 (sm_80 and up)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the values of the tile being consumed: slot j's channel c at j C + c
template <int kW>
struct ReduceScratch {
  float val[kT * kW];
};

// a lane's share of a tile's values, loaded before its members are marked
template <int kW>
struct TileVals {
  float v[kW];
};

template <int kC>
struct ReduceOp {
  static constexpr bool kValues = true;
  static constexpr int kW = kWidth<kC>;
  using Stage = ValStage;
  using Scratch = ReduceScratch<kW>;
  const float* values;  // (P, channels): the values of each target point
  int channels;         // kC where kC > 0
  int* count_out;       // (nq,)
  float* out;           // (nq, channels)

  __device__ __forceinline__ int width() const { return kC > 0 ? kC : channels; }

  struct State {
    int n;
    float acc[kW];
  };
  __device__ __forceinline__ State init() const {
    State s;
    s.n = 0;
#pragma unroll
    for (int c = 0; c < kW; ++c) s.acc[c] = 0.f;
    return s;
  }
  // element lane + 32 i of the staged tile's n x C values (0 past them),
  // through its slots' point indices
  __device__ __forceinline__ TileVals<kW> value(const Stage& st, int lane) const {
    TileVals<kW> t;
    const int w = width(), total = st.n * w;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int k = lane + 32 * i;
      t.v[i] = k < total ? __ldg(values + st.idx[k / w] * w + k % w) : 0.f;
    }
    return t;
  }
  // The warp, all lanes: this lane's members among the tile's n points
  // (where `reach`) marked, the tile's values stored, then each member's
  // values added in slot order, each channel on its own. Returns how many.
  __device__ __forceinline__ int tile(State& s, float qx, float qy, float qz, bool reach,
                                      const float4* pt, int n, const TileVals<kW>& t,
                                      Scratch& x, int lane, float r2) const {
    unsigned m = 0;
    if (reach) {
      for (int j = 0; j < n; ++j) {
        m |= static_cast<unsigned>(sq_dist(qx, qy, qz, pt[j].x, pt[j].y, pt[j].z) <= r2) << j;
      }
    }
    const int w = width(), total = n * w;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int k = lane + 32 * i;
      if (k < total) x.val[k] = t.v[i];
    }
    __syncwarp();
    const int added = __popc(m);
    s.n += added;
    while (m != 0) {
      const int j = __ffs(static_cast<int>(m)) - 1;
      m &= m - 1;
      const float* v = x.val + j * w;
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        if (c < w) s.acc[c] = __fadd_rn(s.acc[c], v[c]);
      }
    }
    return added;
  }
  // the count and each channel's sum
  __device__ __forceinline__ void write(const State& s, long long row, float, float,
                                        float) const {
    const int w = width();
    count_out[row] = s.n;
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      if (c < w) out[row * w + c] = s.acc[c];
    }
  }
};

// L's max, order-free: a member's value enters through its key, an
// unsigned integer in the float's order (a larger float, a larger key),
// every NaN the largest key, so an integer max is amax's NaN-propagating
// max; 0 stands for no member (below every float's key).
__device__ __forceinline__ unsigned max_key(float v) {
  const unsigned u = __float_as_uint(v);
  return v != v ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// the float of a key other than 0 (a NaN for the NaN key)
__device__ __forceinline__ float key_value(unsigned k) {
  return k == 0xffffffffu ? __int_as_float(0x7fffffff)
                          : __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- kernels G and K: one warp a unit of one bucket's queries ----

constexpr int kCounters = 4;        // G, K: the counts a warp writes where asked
constexpr int kBatch = 256;         // G, K: scan positions ordered at once (26 x 8 tiles)
constexpr int kPackThreads = 1024;  // the pre-pass's CTA

// A warp's view of its unit's bucket b: the distinct wrapped neighbours of
// b (ascending where an axis has fewer than 3 cells, else in offset order),
// their filled counts, and the exclusive scan of their tiles
// (ceil(count / kT) each, none for b itself, which is swept first and
// apart): scan position p lies in neighbour k for tstart[k] <= p <
// tstart[k + 1], and tstart[n] is the number of positions.
struct TileDir {
  int id[32];
  int cnt[32];
  int tstart[33];
  int n;
  int own;    // b's rank among the neighbours
  int first;  // the smallest neighbour
};

// Lanes 0..31: the directory of bucket b (counts clamped to cap).
__device__ __forceinline__ void tile_directory(TileDir& d, int b, int gx, int gy, int gz,
                                               const int* __restrict__ count, int cap,
                                               int lane) {
  int n = kNbr, nb = -1;
  if (gx >= 3 && gy >= 3 && gz >= 3) {
    // 27 distinct neighbours: in offset order (the visits' order does not
    // matter: (d2, slot) order decides), the smallest found apart
    if (lane < kNbr) {
      const int bx = b % gx, by = (b / gx) % gy, bz = b / (gx * gy);
      nb = (((bz + lane / 9 - 1 + gz) % gz) * gy + (by + (lane / 3) % 3 - 1 + gy) % gy) * gx +
           (bx + lane % 3 - 1 + gx) % gx;
    }
    int first = lane < kNbr ? nb : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kAll, first, o));
    d.id[lane] = nb;
    if (lane == 0) d.first = first;
  } else {
    n = neighbour_ids(d.id, b, gx, gy, gz, lane);
    nb = lane < n ? d.id[lane] : -1;
    if (lane == 0) d.first = d.id[0];
  }
  const int c = lane < n ? min(count[nb], cap) : 0;
  const bool own = nb == b;
  const unsigned mine = __ballot_sync(kAll, own);
  d.cnt[lane] = c;
  d.tstart[lane + 1] = warp_scan(own ? 0 : (c + kT - 1) / kT, lane);
  if (lane == 0) {
    d.tstart[0] = 0;
    d.n = n;
    d.own = __ffs(static_cast<int>(mine)) - 1;
  }
  __syncwarp();
}

// The slot of this lane's query: the answered slot (q_ok, in slot order)
// of rank r0 + lane in its bucket, -1 if the bucket has fewer; 256 slots a
// pass, eight a lane.
__device__ __forceinline__ int unit_slot(const unsigned char* __restrict__ ok, int cap,
                                         int r0, int* tab, int lane) {
  tab[lane] = -1;
  __syncwarp();
  int seen = 0;
  for (int c0 = 0; c0 < cap && seen < r0 + 32; c0 += 256) {
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = c0 + lane * 8 + i;
      if (s < cap && ok[s]) bits |= 1u << i;
    }
    const int c = __popc(bits);
    const int incl = warp_scan(c, lane);
    int rank = seen + incl - c;
    while (bits != 0) {
      const int i = __ffs(static_cast<int>(bits)) - 1;
      bits &= bits - 1;
      if (rank >= r0 && rank < r0 + 32) tab[rank - r0] = c0 + lane * 8 + i;
      ++rank;
    }
    seen += __shfl_sync(kAll, incl, 31);
  }
  __syncwarp();
  const int slot = tab[lane];
  __syncwarp();
  return slot;
}

__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Tile t = {code (bucket * tiles + tile), filled slots n} into stage `st`
// (cull.cuh's sweep issues it): its points 16 bytes a lane where the grid's
// runs are 16-byte aligned (a16: cap % 4 == 0 and an aligned base; a
// partial run then ends at most 12 bytes past its last slot, inside its
// bucket), else 4 bytes a lane; its box by lanes 30 and 31.
__device__ __forceinline__ void issue_tile(GridStage& st, const float* __restrict__ t_xyz,
                                           const float4* __restrict__ boxes, int2 t,
                                           int tiles, int cap, bool a16, int lane) {
  const int g0 = t.x / tiles * cap + t.x % tiles * kT;
  const float* src = t_xyz + 3LL * g0;
  const int nf = 3 * t.y;
  if (a16) {
    if (4 * lane < nf) cp_async16_ca(&st.pt[4 * lane], src + 4 * lane);
  } else {
    for (int i = lane; i < nf; i += 32) cp_async4(&st.pt[i], src + i);
  }
  if (lane >= 30) cp_async16(lane == 30 ? &st.lo : &st.hi, boxes + 2LL * t.x + lane - 30);
  if (lane == 0) {
    st.g0 = g0;
    st.n = t.y;
  }
}

// Kernel G's selection. Each lane keeps its query's first member in (d2,
// slot) order (slot order is candidate order: the neighbours are
// ascending), a member being within r2; that is the query's threshold, and
// a tile is reached when its bound is within r2 and comes before it.
struct NnSel {
  const long long* t_idx;  // target cell_idx (H, cap)
  int n_p;
  float r2;
  int* idx_out;
  float* d2_out;

  struct State {
    float d;
    int g;  // -1: no member yet, d = BIG
  };
  __device__ __forceinline__ State init() const { return {kBig, -1}; }
  __device__ __forceinline__ void bound(const State& s, float& d, int& i) const {
    d = s.d;
    i = s.g;
  }
  __device__ __forceinline__ float worst(float d) const { return fminf(d, r2); }
  __device__ __forceinline__ bool reaches(float bb, int g0, float d, int i) const {
    return bb <= r2 && before(bb, g0, d, i);
  }
  __device__ __forceinline__ void consume(State& s, float qx, float qy, float qz,
                                          const GridStage& st, float, int) const {
#pragma unroll 4
    for (int j = 0; j < st.n; ++j) {
      const float d2 = sq_dist(qx, qy, qz, st.pt[3 * j], st.pt[3 * j + 1], st.pt[3 * j + 2]);
      if (d2 <= r2 && before(d2, st.g0 + j, s.d, s.g)) {
        s.d = d2;
        s.g = st.g0 + j;
      }
    }
  }
  // the query's first member, or (BIG, its first candidate's index: slot 0
  // of the smallest neighbour, what argmin over a row of BIG returns)
  __device__ __forceinline__ void finish(const State& s, long long row, const TileDir& dir,
                                         int cap) const {
    const long long r = t_idx[s.g < 0 ? static_cast<long long>(dir.first) * cap : s.g];
    idx_out[row] = r >= n_p ? 0 : static_cast<int>(r);
    d2_out[row] = s.d;
  }
};

// Kernel K's selection. Each lane keeps its query's first kK candidates in
// (d2, slot) order in registers, a candidate at BIG or beyond (or, with
// exclude, at d2 <= 1e-12) never entering, so an unfilled entry stays (BIG,
// INT_MAX); the kK-th entry is the query's threshold, and a tile is
// reached when its bound comes before it.
struct KnnSel {
  const long long* t_idx;  // target cell_idx (H, cap)
  int n_p;
  int k;
  int exclude;  // exclude_self: d2 <= 1e-12 goes to BIG
  float r2;     // valid = d2 <= r2
  int* idx_out;              // (nq, k)
  float* d2_out;             // (nq, k)
  unsigned char* valid_out;  // (nq, k)

  struct State {
    float d[kK];
    int i[kK];
  };
  __device__ __forceinline__ State init() const {
    State s;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      s.d[j] = kBig;
      s.i[j] = INT_MAX;
    }
    return s;
  }
  __device__ __forceinline__ void bound(const State& s, float& d, int& i) const {
    d = s.d[kK - 1];
    i = s.i[kK - 1];
  }
  __device__ __forceinline__ float worst(float d) const { return d; }
  __device__ __forceinline__ bool reaches(float bb, int g0, float d, int i) const {
    return before(bb, g0, d, i);
  }
  // the tile's candidates all at once against the threshold at its start
  // (no branch), then each of them against the kK-th as it is then
  __device__ __forceinline__ void consume(State& s, float qx, float qy, float qz,
                                          const GridStage& st, float bd, int bi) const {
    unsigned cand = 0;
#pragma unroll 4
    for (int j = 0; j < st.n; ++j) {
      const float d2 = sq_dist(qx, qy, qz, st.pt[3 * j], st.pt[3 * j + 1], st.pt[3 * j + 2]);
      const bool in = d2 < kBig && !(exclude && d2 <= 1e-12f) && before(d2, st.g0 + j, bd, bi);
      cand |= static_cast<unsigned>(in) << j;
    }
    while (cand != 0) {
      const int j = __ffs(static_cast<int>(cand)) - 1;
      cand &= cand - 1;
      const float d2 = sq_dist(qx, qy, qz, st.pt[3 * j], st.pt[3 * j + 1], st.pt[3 * j + 2]);
      if (before(d2, st.g0 + j, s.d[kK - 1], s.i[kK - 1])) insert(s.d, s.i, d2, st.g0 + j);
    }
  }
  __device__ __forceinline__ void finish(const State& s, long long row, const TileDir&,
                                         int) const {
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      if (j < k) {
        const float d = s.d[j];
        int r = 0;
        if (d < kBig) {
          const long long t = t_idx[s.i[j]];
          r = t >= n_p ? 0 : static_cast<int>(t);
        }
        idx_out[row * k + j] = r;
        d2_out[row * k + j] = d;
        valid_out[row * k + j] = d <= r2;
      }
    }
  }
};

// a warp's shared memory: its directory, its ring, a batch of the other
// tiles' bounds, and its unit's slots
struct SelShared {
  TileDir dir;
  GridStage ring[kStages];
  float lb[kBatch];    // the batch's scan positions: their bound from the queries' box
  int2 tile[kBatch];   // and their tile {code, filled slots}
  int slots[32];
};

// Kernels G and K. A persistent grid: warp w takes the units w, w + W, ...
// (W the grid's warps) of the pre-pass's list, a unit being up to 32
// answered slots of one query bucket, a lane a query. A unit sweeps its
// bucket's own tiles first, then the other neighbours' tiles in increasing
// bound from the box of the warp's queries, kBatch scan positions at a
// time, while that bound is within the loosest threshold: a tile is visited
// when its box bound reaches some query (Op::reaches), and checked again
// when it arrives. `counters`, where given, receives per warp the (query,
// candidate) pairs compared, the tiles visited, the units and the queries
// answered.
template <class Op>
__global__ void __launch_bounds__(kThreads)
grid_select_kernel(const float* __restrict__ t_xyz, const float4* __restrict__ boxes,
                   const int* __restrict__ t_count, const float* __restrict__ q_xyz,
                   const long long* __restrict__ q_idx, const unsigned char* __restrict__ q_ok,
                   const int* __restrict__ units, int max_units, int cap, int gx, int gy,
                   int gz, bool a16, long long* __restrict__ counters, Op op) {
  __shared__ SelShared shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  SelShared& sh = shared[warp];
  const int tiles = (cap + kT - 1) / kT, gmax = (cap + 31) / 32;
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  const int n_units = min(units[0], max_units);
  long long pairs = 0, visited = 0, done = 0, answered = 0;
  const auto issue = [&](GridStage& st, int2 t) {
    issue_tile(st, t_xyz, boxes, t, tiles, cap, a16, lane);
  };
  for (int u = blockIdx.x * kWarps + warp; u < n_units; u += gridDim.x * kWarps) {
    const int code = units[1 + u];
    const int b = code / gmax;
    __syncwarp();  // the last unit's directory and tables are read
    tile_directory(sh.dir, b, gx, gy, gz, t_count, cap, lane);
    const int slot = unit_slot(q_ok + static_cast<long long>(b) * cap, cap, code % gmax * 32,
                               sh.slots, lane);
    const bool active = slot >= 0;
    const long long qslot = static_cast<long long>(b) * cap + (active ? slot : 0);
    const float qx = active ? q_xyz[3 * qslot] : nan;  // NaN: reaches nothing
    const float qy = active ? q_xyz[3 * qslot + 1] : nan;
    const float qz = active ? q_xyz[3 * qslot + 2] : nan;
    const int n_q = __popc(__ballot_sync(kAll, active));
    const Box qb = warp_box(active, qx, qy, qz);
    typename Op::State st = op.init();

    auto consume = [&](const GridStage& s) {
      float bd;
      int bi;
      op.bound(st, bd, bi);
      const bool reach =
          active && op.reaches(box_bound(qx, qy, qz, s.lo, s.hi), s.g0, bd, bi);
      if (__any_sync(kAll, reach)) {
        op.consume(st, qx, qy, qz, s, bd, bi);
        pairs += static_cast<long long>(n_q) * s.n;
        ++visited;
      }
    };

    // the own bucket's tiles, all of them, in order
    const int own_n = sh.dir.cnt[sh.dir.own];
    int t_own = 0;
    sweep(sh.ring, [&]() -> int2 {
      if (t_own * kT >= own_n) return make_int2(-1, 0);
      const int t = t_own++;
      return make_int2(b * tiles + t, min(kT, own_n - t * kT));
    }, issue, consume);

    // then the other neighbours' tiles, nearest first: kBatch scan
    // positions at a time (all of them up to a cap of 256), each with its
    // bound from the box of the warp's queries, taken in increasing order
    // while the next is within the loosest threshold, and visited when it
    // reaches some query
    const int total = sh.dir.tstart[sh.dir.n];
    int base = -kBatch, n_batch = 0;
    unsigned taken = ~0u;  // bit i: this lane's position lane + 32 i, done
    sweep(sh.ring, [&]() -> int2 {
      for (;;) {
        float bd;
        int bi;
        op.bound(st, bd, bi);
        float worst = active ? op.worst(bd) : -inf;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) worst = fmaxf(worst, __shfl_xor_sync(kAll, worst, o));
        // this lane's nearest position left, then the warp's (ties to the
        // lower position)
        float near = inf;
        int at = INT_MAX;
#pragma unroll
        for (int i = 0; i < kBatch / 32; ++i) {
          const float lb = sh.lb[lane + 32 * i];
          if (!((taken >> i) & 1u) && lb < near) {
            near = lb;
            at = lane + 32 * i;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float on = __shfl_xor_sync(kAll, near, o);
          const int oa = __shfl_xor_sync(kAll, at, o);
          if (on < near || (on == near && oa < at)) {
            near = on;
            at = oa;
          }
        }
        if (at == INT_MAX || !(near <= worst)) {  // the batch is done: the next
          base += kBatch;
          if (base >= total) return make_int2(-1, 0);
          n_batch = min(kBatch, total - base);
          __syncwarp();  // the last batch's bounds are read
#pragma unroll
          for (int i = 0; i < kBatch / 32; ++i) {
            const int j = lane + 32 * i, p = base + j;
            float lb = inf;
            int2 tile = make_int2(-1, 0);
            if (j < n_batch) {
              int lo = 0, hi = sh.dir.n;  // tstart[lo] <= p < tstart[hi]
              while (hi - lo > 1) {
                const int mid = (lo + hi) / 2;
                if (sh.dir.tstart[mid] <= p) lo = mid; else hi = mid;
              }
              const int t = p - sh.dir.tstart[lo];
              tile = make_int2(sh.dir.id[lo] * tiles + t, min(kT, sh.dir.cnt[lo] - t * kT));
              lb = boxes_bound(qb, __ldg(boxes + 2LL * tile.x), __ldg(boxes + 2LL * tile.x + 1));
            }
            sh.lb[j] = lb;
            sh.tile[j] = tile;
          }
          taken = 0;
          __syncwarp();
          continue;
        }
        if (lane == at % 32) taken |= 1u << (at / 32);
        const int2 tile = sh.tile[at];
        const int g0 = tile.x / tiles * cap + tile.x % tiles * kT;
        const bool reach = active && op.reaches(
            box_bound(qx, qy, qz, __ldg(boxes + 2LL * tile.x), __ldg(boxes + 2LL * tile.x + 1)),
            g0, bd, bi);
        if (__any_sync(kAll, reach)) return tile;
      }
    }, issue, consume);

    if (active) op.finish(st, q_idx[qslot], sh.dir, cap);
    ++done;
    answered += n_q;
  }
  if (counters != nullptr && lane == 0) {
    long long* c = counters + kCounters * (blockIdx.x * kWarps + warp);
    c[0] = pairs;
    c[1] = visited;
    c[2] = done;
    c[3] = answered;
  }
}

// ---- kernels H and J: one warp a unit, its members in candidate order ----

constexpr int kRadiusCounters = 5;  // H, J: the counts a warp writes where asked

__device__ __forceinline__ void cp_async8_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Lanes 0..31: the directory of bucket b in candidate order: its distinct
// wrapped neighbours ascending (b among them), their filled counts (clamped
// to cap) and the exclusive scan of their tiles (own and first unset).
__device__ __forceinline__ void candidate_directory(TileDir& d, int b, int gx, int gy, int gz,
                                                    const int* __restrict__ count, int cap,
                                                    int lane) {
  const int n = neighbour_ids(d.id, b, gx, gy, gz, lane);
  const int c = lane < n ? min(count[d.id[lane]], cap) : 0;
  d.cnt[lane] = c;
  d.tstart[lane + 1] = warp_scan((c + kT - 1) / kT, lane);
  if (lane == 0) {
    d.tstart[0] = 0;
    d.n = n;
  }
  __syncwarp();
}

// A unit's walk for H, J and I (cull.cuh's sweep: its next()): the tiles
// of its directory in candidate order (ascending neighbour, then tile), 32
// positions a batch, those whose box lies within r2 of the box `qb` of the
// unit's queries (boxes_bound); {-1, 0} once none is left. The warp, all
// lanes; `batch` the warp's 32 entries of shared memory.
struct NearTiles {
  int base = -32;
  unsigned left = 0;  // the batch's positions within r2 of the queries' box, to issue

  __device__ __forceinline__ int2 next(const TileDir& dir, int2* batch,
                                       const float4* __restrict__ boxes, const Box& qb,
                                       int tiles, float r2, int lane) {
    const int total = dir.tstart[dir.n];
    while (left == 0) {
      base += 32;
      if (base >= total) return make_int2(-1, 0);
      const int p = base + lane;
      int2 tile = make_int2(-1, 0);
      bool near = false;
      if (p < total) {
        int lo = 0, hi = dir.n;  // tstart[lo] <= p < tstart[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (dir.tstart[mid] <= p) lo = mid; else hi = mid;
        }
        const int t = p - dir.tstart[lo];
        tile = make_int2(dir.id[lo] * tiles + t, min(kT, dir.cnt[lo] - t * kT));
        near = boxes_bound(qb, __ldg(boxes + 2LL * tile.x),
                           __ldg(boxes + 2LL * tile.x + 1)) <= r2;
      }
      __syncwarp();  // the last batch's tiles are read
      batch[lane] = tile;
      left = __ballot_sync(kAll, near);
      __syncwarp();
    }
    const int j = __ffs(static_cast<int>(left)) - 1;
    left &= left - 1;
    return batch[j];
  }
};

// a warp's shared memory: its directory, its ring, the batch's tiles, the
// tile being consumed as float4 points, the op's scratch and its unit's
// slots
template <class Op>
struct RadiusShared {
  TileDir dir;
  typename Op::Stage ring[kStages];
  int2 tile[32];
  float4 pt[kT];
  typename Op::Scratch scratch;
  int slots[32];
};

// Kernels H, J and L's sweep route. Warp w of the grid takes unit w of
// the pre-pass's list (a warp past the list's count exits), a unit being
// up to 32 answered
// slots of one query bucket, a lane a query (blockIdx.y J's sigma group):
// the grid covers the longest list the buffer holds, so the card's block
// scheduler balances units of unequal work. A unit walks its bucket's
// candidate tiles in candidate order (ascending neighbour, then tile), 32
// positions at a time: a tile is issued when its box lies within r2 of the
// box of the unit's queries (boxes_bound); when it arrives it is rewritten
// as float4 points and each lane whose own bound (box_bound) is within r2
// adds its members in slot order (Op::tile): the sums of the sweep, whose
// other candidates add nothing.
// With kCount, `counters` receives per warp that takes a unit the (query,
// candidate) pairs compared, the tiles visited, 1 (its unit), the queries
// answered and the members added; without it the kernel counts nothing.
template <class Op, bool kCount>
__global__ void __launch_bounds__(kThreads)
grid_radius_kernel(const float* __restrict__ t_xyz, const long long* __restrict__ t_idx,
                   const float4* __restrict__ boxes, const int* __restrict__ t_count,
                   const float* __restrict__ q_xyz, const long long* __restrict__ q_idx,
                   const unsigned char* __restrict__ q_ok, const int* __restrict__ units,
                   int max_units, int cap, int gx, int gy, int gz, float r2, bool a16,
                   long long* __restrict__ counters, Op op) {
  using Stage = typename Op::Stage;
  __shared__ RadiusShared<Op> shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  RadiusShared<Op>& sh = shared[warp];
  const int tiles = (cap + kT - 1) / kT, gmax = (cap + 31) / 32;
  const float nan = __int_as_float(0x7fc00000);
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (u >= min(units[0], max_units)) return;  // the whole warp
  long long pairs = 0, visited = 0, members = 0;
  const auto issue = [&](Stage& st, int2 t) {
    issue_tile(st, t_xyz, boxes, t, tiles, cap, a16, lane);
    if constexpr (Op::kValues) {  // the slots' point indices, 8 bytes a lane
      const long long g0 = static_cast<long long>(t.x / tiles) * cap + t.x % tiles * kT;
      if (lane < t.y) cp_async8_ca(&st.idx[lane], t_idx + g0 + lane);
    }
  };
  const int code = units[1 + u];
  const int b = code / gmax;
  candidate_directory(sh.dir, b, gx, gy, gz, t_count, cap, lane);
  const int slot = unit_slot(q_ok + static_cast<long long>(b) * cap, cap, code % gmax * 32,
                             sh.slots, lane);
  const bool active = slot >= 0;
  const long long qslot = static_cast<long long>(b) * cap + (active ? slot : 0);
  const float qx = active ? q_xyz[3 * qslot] : nan;  // NaN: reaches nothing
  const float qy = active ? q_xyz[3 * qslot + 1] : nan;
  const float qz = active ? q_xyz[3 * qslot + 2] : nan;
  const Box qb = warp_box(active, qx, qy, qz);
  typename Op::State st = op.init();

  NearTiles walk;
  sweep(sh.ring, [&]() { return walk.next(sh.dir, sh.tile, boxes, qb, tiles, r2, lane); },
        issue, [&](const Stage& s) {
    const GridStage& g = s;
    const bool reach = active && box_bound(qx, qy, qz, g.lo, g.hi) <= r2;
    const unsigned lanes = __ballot_sync(kAll, reach);
    if (lanes == 0) return;  // warp-uniform
    const auto v = op.value(s, lane);  // J, L: in flight while the members are marked
    if (lane < g.n) {
      sh.pt[lane] = make_float4(g.pt[3 * lane], g.pt[3 * lane + 1], g.pt[3 * lane + 2], 0.f);
    }
    __syncwarp();
    const int added = op.tile(st, qx, qy, qz, reach, sh.pt, g.n, v, sh.scratch, lane, r2);
    if constexpr (kCount) {
      pairs += static_cast<long long>(__popc(lanes)) * g.n;
      ++visited;
      members += added;
    }
  });

  if (active) op.write(st, q_idx[qslot], qx, qy, qz);
  if constexpr (kCount) {
    const int answered = __popc(__ballot_sync(kAll, active));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) members += __shfl_xor_sync(kAll, members, o);
    if (lane == 0) {
      long long* c = counters + kRadiusCounters *
          ((static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kWarps + warp);
      c[0] = pairs;
      c[1] = visited;
      c[2] = 1;
      c[3] = answered;
      c[4] = members;
    }
  }
}

// ---- kernel I: one warp a unit, its lanes on a tile's slots ----

constexpr int kCountCounters = 8;  // I: the counts a warp writes where asked
// I: a tile whose straddling queries number more than kLoopTenths / 10 of
// its filled slots is counted a lane a query over the slots, else a step a
// query with the lanes on the slots
constexpr int kLoopTenths = 7;

// a warp's shared memory: its directory, its ring, its unit's queries, the
// tile being counted a lane a query, the batch's tiles and its unit's
// slots
struct CountShared {
  TileDir dir;
  GridStage ring[kStages];
  float4 q[32];   // the unit's queries, a lane each
  float4 pt[kT];  // the tile being counted a lane a query, as float4 points
  int2 tile[32];
  int slots[32];
};

// Kernel I. Warp w of the grid takes unit w of the pre-pass's list (a warp
// past the list's count exits), a lane a query, and walks its bucket's
// tiles as H and J do (NearTiles). On each tile that arrives a lane whose
// query straddles the radius (its box bound within r2) counts its members
// there (sq_dist, the plain version's d2) in one of two ways, as
// the tile's straddling queries and filled slots make cheaper
// (kLoopTenths): a step a straddling query, four a pass, with the lanes on
// the tile's slots (the query read by every lane from shared memory, the
// ballot's popcount added by the query's lane), or each straddling lane
// over the slots, the tile rewritten as float4 points. Each answered row
// gets its count minus `sub`.
// With kCount, `counters` receives per warp that takes a unit the (query,
// point) pairs compared (a straddling query against the tile's filled
// slots), the tiles visited, 1 (its unit), the queries answered, the
// members counted, the straddling (query, tile) pairs, the warp's steps
// (one a tile for its bounds, then one a straddling query, or one a filled
// slot where the lanes loop) and the tiles counted a lane a query; without
// it the kernel counts nothing.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
grid_count_kernel(const float* __restrict__ t_xyz, const float4* __restrict__ boxes,
                  const int* __restrict__ t_count, const float* __restrict__ q_xyz,
                  const long long* __restrict__ q_idx, const unsigned char* __restrict__ q_ok,
                  const int* __restrict__ units, int max_units, int cap, int gx, int gy,
                  int gz, float r2, bool a16, int sub, int* __restrict__ out,
                  long long* __restrict__ counters) {
  __shared__ CountShared shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  CountShared& sh = shared[warp];
  const int tiles = (cap + kT - 1) / kT, gmax = (cap + 31) / 32;
  const float nan = __int_as_float(0x7fc00000);
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (u >= min(units[0], max_units)) return;  // the whole warp
  const int code = units[1 + u];
  const int b = code / gmax;
  candidate_directory(sh.dir, b, gx, gy, gz, t_count, cap, lane);
  const int slot = unit_slot(q_ok + static_cast<long long>(b) * cap, cap, code % gmax * 32,
                             sh.slots, lane);
  const bool active = slot >= 0;
  const long long qslot = static_cast<long long>(b) * cap + (active ? slot : 0);
  const float qx = active ? q_xyz[3 * qslot] : nan;  // NaN: within no bound
  const float qy = active ? q_xyz[3 * qslot + 1] : nan;
  const float qz = active ? q_xyz[3 * qslot + 2] : nan;
  const Box qb = warp_box(active, qx, qy, qz);
  sh.q[lane] = make_float4(qx, qy, qz, 0.f);  // read by the steps after the ring's syncs
  int n = 0;  // this lane's members
  long long pairs = 0, visited = 0, straddling = 0, steps = 0, looped = 0;

  NearTiles walk;
  sweep(sh.ring, [&]() { return walk.next(sh.dir, sh.tile, boxes, qb, tiles, r2, lane); },
        [&](GridStage& st, int2 t) { issue_tile(st, t_xyz, boxes, t, tiles, cap, a16, lane); },
        [&](const GridStage& g) {
    unsigned s = __ballot_sync(kAll, box_bound(qx, qy, qz, g.lo, g.hi) <= r2);
    const bool loop = __popc(s) * 10 > g.n * kLoopTenths;  // warp-uniform
    if constexpr (kCount) {
      pairs += static_cast<long long>(__popc(s)) * g.n;
      ++visited;
      straddling += __popc(s);
      steps += 1 + (s == 0 ? 0 : (loop ? g.n : __popc(s)));
      looped += s != 0 && loop;
    }
    if (s == 0) return;  // warp-uniform
    if (loop) {  // a lane a straddling query
      if (lane < g.n) {
        sh.pt[lane] = make_float4(g.pt[3 * lane], g.pt[3 * lane + 1], g.pt[3 * lane + 2], 0.f);
      }
      __syncwarp();
      if ((s >> lane) & 1u) {
#pragma unroll 4
        for (int j = 0; j < g.n; ++j) {
          const float4 p = sh.pt[j];
          n += sq_dist(qx, qy, qz, p.x, p.y, p.z) <= r2;
        }
      }
      return;  // the ring's __syncwarp comes before the next tile's writes
    }
    const bool mine = lane < g.n;  // this lane's slot; NaN past the filled ones
    const float px = mine ? g.pt[3 * lane] : nan;
    const float py = mine ? g.pt[3 * lane + 1] : nan;
    const float pz = mine ? g.pt[3 * lane + 2] : nan;
    // the next straddling query (-1 past the last) and the lanes' slots
    // within r2 of it (query j read by every lane)
    const auto next = [&s]() {
      const int j = __ffs(static_cast<int>(s)) - 1;
      s &= s - 1;
      return j;
    };
    const auto step = [&](int j) {
      const float4 a = sh.q[max(j, 0)];
      return __ballot_sync(kAll, sq_dist(a.x, a.y, a.z, px, py, pz) <= r2);
    };
    do {  // four straddling queries a pass; past the last, j = -1 (no lane's)
      const int j0 = next(), j1 = next(), j2 = next(), j3 = next();
      const unsigned m0 = step(j0), m1 = step(j1), m2 = step(j2), m3 = step(j3);
      n += lane == j0 ? __popc(m0) : 0;
      n += lane == j1 ? __popc(m1) : 0;
      n += lane == j2 ? __popc(m2) : 0;
      n += lane == j3 ? __popc(m3) : 0;
    } while (s != 0);
  });

  if (active) out[q_idx[qslot]] = n - sub;
  if constexpr (kCount) {
    const int answered = __popc(__ballot_sync(kAll, active));
    long long members = n;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) members += __shfl_xor_sync(kAll, members, o);
    if (lane == 0) {
      long long* c = counters + kCountCounters * (static_cast<long long>(blockIdx.x) * kWarps +
                                                  warp);
      c[0] = pairs;
      c[1] = visited;
      c[2] = 1;
      c[3] = answered;
      c[4] = members;
      c[5] = straddling;
      c[6] = steps;
      c[7] = looped;
    }
  }
}

// ---- kernel L's max: I's schedule, the values' keys maxed ----

// a warp's shared memory: its directory, its ring (tiles with their slots'
// point indices), its unit's queries, the tile being maxed a lane a query
// and its values' keys, the batch's tiles and its unit's slots
template <int kW>
struct MaxShared {
  TileDir dir;
  ValStage ring[kStages];
  float4 q[32];          // the unit's queries, a lane each
  float4 pt[kT];         // the tile, as float4 points, where the lanes loop
  unsigned key[kT * kW]; // and its slot j's channel c key at j kW + c
  int2 tile[32];
  int slots[32];
};

// Kernel L's max on the sweep route: I's kernel with each member's values
// maxed. Warp w of the grid takes unit w of the pre-pass's list, a lane a
// query, walks its bucket's tiles (NearTiles) and on each tile that arrives
// takes the lanes whose query straddles the radius (box_bound within r2).
// Each lane loads its slot's values (through the staged point indices) as
// keys (max_key). Where the straddling queries are few against the tile's
// filled slots (kLoopTenths) the warp takes a step a straddling query, four
// a pass, lanes on the slots: a ballot of the slots within r2 of the query
// (sq_dist, the plain version's d2), its popcount added to the query's
// count, and a warp max (__reduce_max_sync) a channel of the keys of those
// slots, maxed into the query's lane; else each straddling lane loops over
// the slots, its keys and points in shared memory. A max is exact in any
// order, so the result is the plain version's whatever the order: per
// answered row the member count and, per channel, the value of the largest
// key, with the plain version's -BIG of a non-member where the query has
// fewer members than its `candidates` positions (27 cap); NaN where a
// member's value is NaN. With kCount, `counters` receives I's 8 counts a
// warp that takes a unit (grid_count_kernel's).
template <int kC, bool kCount>
__global__ void __launch_bounds__(kThreads)
grid_max_kernel(const float* __restrict__ t_xyz, const long long* __restrict__ t_idx,
                const float4* __restrict__ boxes, const int* __restrict__ t_count,
                const float* __restrict__ values, int channels, int candidates,
                const float* __restrict__ q_xyz, const long long* __restrict__ q_idx,
                const unsigned char* __restrict__ q_ok, const int* __restrict__ units,
                int max_units, int cap, int gx, int gy, int gz, float r2, bool a16,
                int* __restrict__ count_out, float* __restrict__ out,
                long long* __restrict__ counters) {
  constexpr int kW = kWidth<kC>;
  __shared__ MaxShared<kW> shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  MaxShared<kW>& sh = shared[warp];
  const int w = kC > 0 ? kC : channels;
  const int tiles = (cap + kT - 1) / kT, gmax = (cap + 31) / 32;
  const float nan = __int_as_float(0x7fc00000);
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (u >= min(units[0], max_units)) return;  // the whole warp
  const int code = units[1 + u];
  const int b = code / gmax;
  candidate_directory(sh.dir, b, gx, gy, gz, t_count, cap, lane);
  const int slot = unit_slot(q_ok + static_cast<long long>(b) * cap, cap, code % gmax * 32,
                             sh.slots, lane);
  const bool active = slot >= 0;
  const long long qslot = static_cast<long long>(b) * cap + (active ? slot : 0);
  const float qx = active ? q_xyz[3 * qslot] : nan;  // NaN: within no bound
  const float qy = active ? q_xyz[3 * qslot + 1] : nan;
  const float qz = active ? q_xyz[3 * qslot + 2] : nan;
  const Box qb = warp_box(active, qx, qy, qz);
  sh.q[lane] = make_float4(qx, qy, qz, 0.f);  // read by the steps after the ring's syncs
  int n = 0;  // this lane's members
  unsigned acc[kW];  // and the largest key of each channel
#pragma unroll
  for (int c = 0; c < kW; ++c) acc[c] = 0u;
  long long pairs = 0, visited = 0, straddling = 0, steps = 0, looped = 0;

  NearTiles walk;
  sweep(sh.ring, [&]() { return walk.next(sh.dir, sh.tile, boxes, qb, tiles, r2, lane); },
        [&](ValStage& st, int2 t) {
          issue_tile(st, t_xyz, boxes, t, tiles, cap, a16, lane);
          const long long g0 = static_cast<long long>(t.x / tiles) * cap + t.x % tiles * kT;
          if (lane < t.y) cp_async8_ca(&st.idx[lane], t_idx + g0 + lane);
        },
        [&](const ValStage& g) {
    const bool mine = lane < g.n;  // this lane's slot
    unsigned key[kW];  // its values' keys, 0 past the filled slots
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      key[c] = mine && c < w ? max_key(__ldg(values + g.idx[lane] * w + c)) : 0u;
    }
    unsigned s = __ballot_sync(kAll, box_bound(qx, qy, qz, g.lo, g.hi) <= r2);
    const bool loop = __popc(s) * 10 > g.n * kLoopTenths;  // warp-uniform
    if constexpr (kCount) {
      pairs += static_cast<long long>(__popc(s)) * g.n;
      ++visited;
      straddling += __popc(s);
      steps += 1 + (s == 0 ? 0 : (loop ? g.n : __popc(s)));
      looped += s != 0 && loop;
    }
    if (s == 0) return;  // warp-uniform
    if (loop) {  // a lane a straddling query
      if (mine) {
        sh.pt[lane] = make_float4(g.pt[3 * lane], g.pt[3 * lane + 1], g.pt[3 * lane + 2], 0.f);
#pragma unroll
        for (int c = 0; c < kW; ++c) sh.key[lane * kW + c] = key[c];
      }
      __syncwarp();
      if ((s >> lane) & 1u) {
        for (int j = 0; j < g.n; ++j) {
          const float4 p = sh.pt[j];
          if (sq_dist(qx, qy, qz, p.x, p.y, p.z) <= r2) {
            ++n;
#pragma unroll
            for (int c = 0; c < kW; ++c) acc[c] = max(acc[c], sh.key[j * kW + c]);
          }
        }
      }
      return;  // the ring's __syncwarp comes before the next tile's writes
    }
    const float px = mine ? g.pt[3 * lane] : nan;  // NaN past the filled slots
    const float py = mine ? g.pt[3 * lane + 1] : nan;
    const float pz = mine ? g.pt[3 * lane + 2] : nan;
    // the next straddling query (-1 past the last) and the lanes' slots
    // within r2 of it (query j read by every lane)
    const auto next = [&s]() {
      const int j = __ffs(static_cast<int>(s)) - 1;
      s &= s - 1;
      return j;
    };
    const auto step = [&](int j) {
      const float4 a = sh.q[max(j, 0)];
      return __ballot_sync(kAll, sq_dist(a.x, a.y, a.z, px, py, pz) <= r2);
    };
    // the members' largest key of each channel into query j's lane
    const auto take = [&](int j, unsigned m) {
      if (j < 0 || m == 0) return;  // warp-uniform
      const bool in = (m >> lane) & 1u;
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        if (c < w) {
          const unsigned top = __reduce_max_sync(kAll, in ? key[c] : 0u);
          if (lane == j) acc[c] = max(acc[c], top);
        }
      }
      if (lane == j) n += __popc(m);
    };
    do {  // four straddling queries a pass; past the last, j = -1 (no lane's)
      const int j0 = next(), j1 = next(), j2 = next(), j3 = next();
      const unsigned m0 = step(j0), m1 = step(j1), m2 = step(j2), m3 = step(j3);
      take(j0, m0);
      take(j1, m1);
      take(j2, m2);
      take(j3, m3);
    } while (s != 0);
  });

  if (active) {
    const long long row = q_idx[qslot];
    count_out[row] = n;
    const unsigned floor = n < candidates ? max_key(-kBig) : 0u;  // a non-member's -BIG
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      if (c < w) out[row * w + c] = key_value(max(acc[c], floor));
    }
  }
  if constexpr (kCount) {
    const int answered = __popc(__ballot_sync(kAll, active));
    long long members = n;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) members += __shfl_xor_sync(kAll, members, o);
    if (lane == 0) {
      long long* c = counters + kCountCounters * (static_cast<long long>(blockIdx.x) * kWarps +
                                                  warp);
      c[0] = pairs;
      c[1] = visited;
      c[2] = 1;
      c[3] = answered;
      c[4] = members;
      c[5] = straddling;
      c[6] = steps;
      c[7] = looped;
    }
  }
}

// ---- kernel L's list route: a warp a query, no query grid ----

// The wrapped bucket of a point: floor(x * inv) per axis as a 64-bit
// integer (core/grid._cells: the float32 product, then the cast), taken
// modulo each axis's cells (_bucket_of).
__device__ __forceinline__ int bucket_of(float x, float y, float z, float inv, int gx, int gy,
                                         int gz) {
  const auto wrap = [inv](float v, int g) {
    const long long c = static_cast<long long>(floorf(__fmul_rn(v, inv)));
    return static_cast<int>(((c % g) + g) % g);
  };
  return (wrap(z, gz) * gy + wrap(y, gy)) * gx + wrap(x, gx);
}

// Kernel L's list route (the small-Q path's queries, each answered). Warp
// w of the grid takes query w: its bucket (bucket_of), the distinct wrapped
// neighbours of that bucket ascending (neighbour_ids, duplicates skipped as
// core/grid._candidates masks them), and lane l the filled slots l, l + 32,
// ... of each neighbour in turn: a member (sq_dist <= r2) adds 1 to the
// lane's count and its values to the lane's sums (or maxes) in that order.
// Slots t * 32 .. t * 32 + 31 of a neighbour are its tile t, whose box the
// pre-pass wrote: the lanes bound 32 of the query's tiles at once, and the
// warp skips a tile whose box bound from the query (box_bound: <= the d2
// of every point in the box, in the same rounded operations) lies beyond
// r2, which holds no member, so the lanes add the same members in the same
// order as with no culling. The lanes' parts are
// then combined by a fixed butterfly of shuffles (xor 16, 8, 4, 2, 1; a + b
// == b + a, so every lane holds the same bits), and lane 0 writes the count
// and the channels, the max with the plain version's -BIG of a non-member
// where the query has one. The width is fixed at compile time where kC > 0,
// else `channels` <= kMaxChannels. A launch repeats bit for bit.
template <bool kMax, int kC>
__global__ void __launch_bounds__(kThreads)
grid_reduce_list_kernel(const float* __restrict__ t_xyz, const long long* __restrict__ t_idx,
                        const int* __restrict__ t_count, const float4* __restrict__ boxes,
                        const float* __restrict__ values, int channels,
                        const float* __restrict__ q, int nq, int cap, int gx, int gy, int gz,
                        float inv_cell, float r2, int* __restrict__ count_out,
                        float* __restrict__ out) {
  constexpr int kW = kWidth<kC>;
  __shared__ int ids[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (qi >= nq) return;  // the whole warp
  const int w = kC > 0 ? kC : channels;
  const int tiles = (cap + kT - 1) / kT;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const int n = neighbour_ids(ids[warp], bucket_of(qx, qy, qz, inv_cell, gx, gy, gz), gx, gy,
                              gz, lane);
  int found = 0;
  float acc[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c) acc[c] = kMax ? -__int_as_float(0x7f800000) : 0.f;
  // the query's tiles, position k tiles + t for tile t of neighbour k: 32
  // positions a pass, each lane bounding one, then the positions within r2
  // in order (candidate order), lane l on slot t kT + l of each
  for (int base = 0; base < n * tiles; base += 32) {
    const int p = base + lane;
    int nb = 0, filled = 0;
    bool near = false;
    if (p < n * tiles) {
      nb = ids[warp][p / tiles];
      filled = min(__ldg(t_count + nb), cap);
      const int t = p % tiles;
      if (t * kT < filled) {
        const long long box = 2LL * (static_cast<long long>(nb) * tiles + t);
        near = box_bound(qx, qy, qz, __ldg(boxes + box), __ldg(boxes + box + 1)) <= r2;
      }
    }
    unsigned left = __ballot_sync(kAll, near);
    while (left != 0) {  // warp-uniform
      const int j = __ffs(static_cast<int>(left)) - 1;
      left &= left - 1;
      const int tnb = __shfl_sync(kAll, nb, j), tfilled = __shfl_sync(kAll, filled, j);
      const int s = (base + j) % tiles * kT + lane;
      const long long slot = static_cast<long long>(tnb) * cap + s;
      const float* pt = t_xyz + 3 * slot;
      if (s < tfilled && sq_dist(qx, qy, qz, __ldg(pt), __ldg(pt + 1), __ldg(pt + 2)) <= r2) {
        ++found;
        const float* v = values + __ldg(t_idx + slot) * w;
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          if (c < w) acc[c] = kMax ? nan_max(acc[c], __ldg(v + c)) : __fadd_rn(acc[c], __ldg(v + c));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    found += __shfl_xor_sync(kAll, found, o);
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const float other = __shfl_xor_sync(kAll, acc[c], o);
      acc[c] = kMax ? nan_max(acc[c], other) : __fadd_rn(acc[c], other);
    }
  }
  if (lane == 0) {
    count_out[qi] = found;
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      if (c < w) out[qi * w + c] = kMax && found < kNbr * cap ? nan_max(acc[c], -kBig) : acc[c];
    }
  }
}

// ---- the pre-pass of G-L ----

static_assert(kPackThreads == 32 * 32, "pack_units scans a warp of warp sums");

// Where the pre-pass's runs of units go: the next free row of the list
// and the unit CTAs done. Both are 0 between launches (the last unit CTA of
// a launch returns them to 0), so no memset comes before a launch. The
// pre-pass's launches on one device therefore run one at a time, as they
// do on one stream (every caller's: PyTorch's current stream).
__device__ int g_unit_next = 0;
__device__ unsigned g_unit_done = 0;

// The unit CTAs of the pre-pass, all their threads, kPackThreads buckets
// a CTA, a thread a bucket: ceil(min(q_count[b], cap) / 32) units b * gmax
// + j (j the unit's group of 32 answered slots), placed after one another
// by a block scan; where the CTA's run goes in the list is handed out by
// an atomic on g_unit_next, so the runs lie in no fixed order, which no
// result depends on (a unit writes its own rows only). The last CTA to
// finish writes the list's length into units[0] (pack_ref's, up to
// max_units) and sets both tickets back to 0.
__device__ __forceinline__ void pack_units(const int* __restrict__ q_count, int h, int cap,
                                           int unit_ctas, int* __restrict__ units,
                                           int max_units) {
  __shared__ int sums[kPackThreads / 32];
  __shared__ int base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gmax = (cap + 31) / 32;
  const int b = blockIdx.x * kPackThreads + threadIdx.x;
  const int mine = b < h ? (min(max(__ldg(q_count + b), 0), cap) + 31) / 32 : 0;
  const int incl = warp_scan(mine, lane);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int all = warp_scan(sums[lane], lane);
    sums[lane] = all;
    if (lane == 31) base = atomicAdd(&g_unit_next, all);
  }
  __syncthreads();
  const int off = base + incl - mine + (warp > 0 ? sums[warp - 1] : 0);
  for (int j = 0; j < mine && off + j < max_units; ++j) units[1 + off + j] = b * gmax + j;
  if (threadIdx.x == 0) {  // this CTA's run is placed (base came back before the sync)
    __threadfence();
    if (atomicAdd(&g_unit_done, 1u) == static_cast<unsigned>(unit_ctas) - 1) {
      units[0] = min(atomicExch(&g_unit_next, 0), max_units);
      atomicExch(&g_unit_done, 0u);
    }
  }
}

// The pre-pass of G-K, one launch with nothing zeroed before it: CTAs 0
// .. unit_ctas - 1 (where units are asked for) list the units
// (pack_units); the CTAs after them (where boxes are asked for) take a thread a tile of the target grid
// (tile t of bucket b at b * tiles + t) and write a filled tile's box (lo,
// hi: the least and largest x, y, z of its filled slots, a NaN left out;
// w 0), folded by the one thread, 16 bytes a read where a16 (the tile starts 16-byte
// aligned, and a group of four slots that holds a filled one ends inside
// its bucket, as cap % 4 == 0). The boxes of empty tiles are not written,
// as no kernel reads them. Min and max are exact in any order, so the
// boxes repeat bit for bit (up to the sign of a zero).
__global__ void __launch_bounds__(kPackThreads)
grid_pack_kernel(const float* __restrict__ t_xyz, const int* __restrict__ t_count,
                 const int* __restrict__ q_count, int h, int cap, int unit_ctas, bool a16,
                 float4* __restrict__ boxes, int* __restrict__ units, int max_units) {
  if (static_cast<int>(blockIdx.x) < unit_ctas) {
    pack_units(q_count, h, cap, unit_ctas, units, max_units);
    return;
  }
  const int tiles = (cap + kT - 1) / kT;
  const int t = (blockIdx.x - unit_ctas) * kPackThreads + threadIdx.x;
  if (t >= h * tiles) return;
  const int b = t / tiles, first = t % tiles * kT;
  const int n = min(min(__ldg(t_count + b), cap) - first, kT);  // its filled slots
  if (n <= 0) return;
  const float* src = t_xyz + 3 * (static_cast<long long>(b) * cap + first);
  const float inf = __int_as_float(0x7f800000);
  Box box{inf, inf, inf, -inf, -inf, -inf};
  const auto fold = [&box](float x, float y, float z) {
    box.lx = fminf(box.lx, x);
    box.ly = fminf(box.ly, y);
    box.lz = fminf(box.lz, z);
    box.hx = fmaxf(box.hx, x);
    box.hy = fmaxf(box.hy, y);
    box.hz = fmaxf(box.hz, z);
  };
  if (a16) {  // four slots (three float4) a step
    const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int g = 0; g < kT / 4; ++g) {
      if (4 * g >= n) break;
      const float4 a = __ldg(v + 3 * g), c = __ldg(v + 3 * g + 1), d = __ldg(v + 3 * g + 2);
      fold(a.x, a.y, a.z);
      if (4 * g + 1 < n) fold(a.w, c.x, c.y);
      if (4 * g + 2 < n) fold(c.z, c.w, d.x);
      if (4 * g + 3 < n) fold(d.y, d.z, d.w);
    }
  } else {
    for (int j = 0; j < n; ++j) fold(src[3 * j], src[3 * j + 1], src[3 * j + 2]);
  }
  boxes[2LL * t] = make_float4(box.lx, box.ly, box.lz, 0.f);
  boxes[2LL * t + 1] = make_float4(box.hx, box.hy, box.hz, 0.f);
}

// the grids' shape as the kernels index them: H = Gx Gy Gz buckets of cap
// slots, every global slot an int
bool grid_shape_ok(int h, int cap, int gx, int gy, int gz) {
  return h >= 1 && cap >= 1 && gx >= 1 && gy >= 1 && gz >= 1 &&
         static_cast<long long>(gx) * gy * gz == h &&
         static_cast<long long>(h) * cap < (1LL << 31);
}

// whether a grid's runs of slots can be read 16 bytes at a time
bool aligned16(const float* t_xyz, int cap) {
  return cap % 4 == 0 && reinterpret_cast<unsigned long long>(t_xyz) % 16 == 0;
}

int launch_pack(const float* t_xyz, const int* t_count, const int* q_count, int h, int cap,
                float* boxes, int* units, int max_units, cudaStream_t stream) {
  const int unit_ctas = units == nullptr ? 0 : (h + kPackThreads - 1) / kPackThreads;
  const long long tiles = static_cast<long long>(h) * ((cap + kT - 1) / kT);
  const int box_ctas =
      boxes == nullptr ? 0 : static_cast<int>((tiles + kPackThreads - 1) / kPackThreads);
  if (unit_ctas + box_ctas == 0) return static_cast<int>(cudaSuccess);
  grid_pack_kernel<<<unit_ctas + box_ctas, kPackThreads, 0, stream>>>(
      t_xyz, t_count, q_count, h, cap, unit_ctas, aligned16(t_xyz, cap),
      reinterpret_cast<float4*>(boxes), units, max_units);
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid of a selection kernel: as many CTAs as the card keeps
// resident (found once a device), fewer where the units cannot fill them.
template <class Op>
int launch_select(const Op& op, const float* t_xyz, const float* boxes, const int* t_count,
                  const float* q_xyz, const long long* q_idx, const unsigned char* q_ok,
                  const int* units, int max_units, int cap, int gx, int gy, int gz,
                  long long* counters, long long counters_len, cudaStream_t stream) {
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, grid_select_kernel<Op>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per > 0 ? per : 1);
  }
  const long long want = (static_cast<long long>(max_units) + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < resident[dev] ? (want > 0 ? want : 1)
                                                           : resident[dev]);
  if (counters != nullptr && counters_len < static_cast<long long>(kCounters) * blocks * kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grid_select_kernel<Op><<<blocks, kThreads, 0, stream>>>(
      t_xyz, reinterpret_cast<const float4*>(boxes), t_count, q_xyz, q_idx, q_ok, units,
      max_units, cap, gx, gy, gz, aligned16(t_xyz, cap), counters, op);
  return static_cast<int>(cudaGetLastError());
}

// A radius kernel (H, J): a warp a unit of the longest list, `groups` of
// the grid on blockIdx.y (J's sigma groups); the counting variant where
// counters are given.
template <bool kCount, class Op>
int launch_radius_grid(const Op& op, int groups, const float* t_xyz, const long long* t_idx,
                       const float* boxes, const int* t_count, const float* q_xyz,
                       const long long* q_idx, const unsigned char* q_ok, const int* units,
                       int max_units, int cap, int gx, int gy, int gz, float r2,
                       long long* counters, long long counters_len, cudaStream_t stream) {
  const int blocks = (max_units + kWarps - 1) / kWarps;
  if (kCount && counters_len < static_cast<long long>(kRadiusCounters) * blocks * groups *
                                   kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grid_radius_kernel<Op, kCount><<<dim3(blocks, groups), kThreads, 0, stream>>>(
      t_xyz, t_idx, reinterpret_cast<const float4*>(boxes), t_count, q_xyz, q_idx, q_ok, units,
      max_units, cap, gx, gy, gz, r2, aligned16(t_xyz, cap), counters, op);
  return static_cast<int>(cudaGetLastError());
}

// H or J whole: the pre-pass (the target's boxes and the units), then the
// radius kernel.
template <class Op>
int launch_radius(const Op& op, int groups, const float* t_xyz, const long long* t_idx,
                  const int* t_count, const float* q_xyz, const long long* q_idx,
                  const unsigned char* q_ok, const int* q_count, int h, int cap, int gx, int gy,
                  int gz, float r2, float* boxes, int* units, int max_units,
                  long long* counters, long long counters_len, void* stream) {
  if (!grid_shape_ok(h, cap, gx, gy, gz) || max_units < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(t_xyz, t_count, q_count, h, cap, boxes, units, max_units, st);
  if (err != 0) return err;
  if (counters != nullptr) {
    return launch_radius_grid<true>(op, groups, t_xyz, t_idx, boxes, t_count, q_xyz, q_idx,
                                    q_ok, units, max_units, cap, gx, gy, gz, r2, counters,
                                    counters_len, st);
  }
  return launch_radius_grid<false>(op, groups, t_xyz, t_idx, boxes, t_count, q_xyz, q_idx,
                                   q_ok, units, max_units, cap, gx, gy, gz, r2, nullptr, 0,
                                   st);
}

}  // namespace

// The grids of core/grid.py:build_grid, both of h = gx gy gz buckets of cap
// slots: the target's t_xyz (h, cap, 3) f32, t_idx (h, cap) i64 (G, J, K)
// and t_count (h,) i32 (slots [0, count) are filled); the query grid's q_xyz
// (h, cap, 3) f32, q_idx (h, cap) i64 (the output row of each slot), q_ok
// (h, cap) bool (the slots to answer) and q_count (h,) i32 (0 where a bucket
// has no slot to answer). r2 the float32 squared radius (K: of `valid`).
// Each returns cudaGetLastError() after its last launch.

// The pre-pass of kernels G, H, J and K alone (grid_pack_kernel): where
// units is not null, the units of the query grid (q_count) into units (1 +
// max_units,) i32; where boxes is not null, the boxes of the target grid's
// tiles into boxes (h * ceil(cap / 32), 2, 4) f32.
extern "C" int mm_grid_pack(const float* t_xyz, const int* t_count, const int* q_count, int h,
                            int cap, int gx, int gy, int gz, float* boxes, int* units,
                            int max_units, void* stream) {
  if (!grid_shape_ok(h, cap, gx, gy, gz) || (units != nullptr && max_units < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pack(t_xyz, t_count, q_count, h, cap, boxes, units, max_units,
                     static_cast<cudaStream_t>(stream));
}

// Kernel G: idx_out (nq,) i32, d2_out (nq,) f32 at the answered rows. Two
// launches: the pre-pass (the target's boxes into `boxes` unless
// boxes_ready, the units into `units` (1 + max_units,) i32), then the
// selection. counters: null, or (counters_len,) i64 receiving 4 counts a
// warp (grid_select_kernel).
extern "C" int mm_grid_nn(const float* t_xyz, const long long* t_idx, const int* t_count,
                          const float* q_xyz, const long long* q_idx,
                          const unsigned char* q_ok, const int* q_count, int h, int cap,
                          int gx, int gy, int gz, float r2, int n_p, float* boxes,
                          int boxes_ready, int* units, int max_units, int* idx_out,
                          float* d2_out, long long* counters, long long counters_len,
                          void* stream) {
  if (!grid_shape_ok(h, cap, gx, gy, gz) || max_units < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(t_xyz, t_count, q_count, h, cap, boxes_ready ? nullptr : boxes,
                              units, max_units, st);
  if (err != 0) return err;
  return launch_select(NnSel{t_idx, n_p, r2, idx_out, d2_out}, t_xyz, boxes, t_count, q_xyz,
                       q_idx, q_ok, units, max_units, cap, gx, gy, gz, counters,
                       counters_len, st);
}

// Kernel H: s0_out (nq,), mean_out (nq, 3), cov_out (nq, 3, 3) f32 at the
// answered rows. Two launches: the pre-pass (the target's boxes into
// `boxes`, the units into `units` (1 + max_units,) i32), then the radius
// kernel. counters: null, or (counters_len,) i64 receiving 5 counts a warp
// (grid_radius_kernel).
extern "C" int mm_grid_moments(const float* t_xyz, const int* t_count, const float* q_xyz,
                               const long long* q_idx, const unsigned char* q_ok,
                               const int* q_count, int h, int cap, int gx, int gy, int gz,
                               float r2, float* boxes, int* units, int max_units,
                               float* s0_out, float* mean_out, float* cov_out,
                               long long* counters, long long counters_len, void* stream) {
  return launch_radius(MomentsOp{s0_out, mean_out, cov_out}, 1, t_xyz, nullptr, t_count,
                       q_xyz, q_idx, q_ok, q_count, h, cap, gx, gy, gz, r2, boxes, units,
                       max_units, counters, counters_len, stream);
}

// Kernel I: out (nq,) i32 at the answered rows, the member count minus sub.
// Two launches: the pre-pass (the target's boxes into `boxes`, the units
// into `units` (1 + max_units,) i32), then the count kernel. counters:
// null, or (counters_len,) i64 receiving 8 counts a warp
// (grid_count_kernel).
extern "C" int mm_grid_count(const float* t_xyz, const int* t_count, const float* q_xyz,
                             const long long* q_idx, const unsigned char* q_ok,
                             const int* q_count, int h, int cap, int gx, int gy, int gz,
                             float r2, int sub, float* boxes, int* units, int max_units,
                             int* out, long long* counters, long long counters_len,
                             void* stream) {
  const int blocks = max_units < 1 ? 0 : (max_units + kWarps - 1) / kWarps;
  if (!grid_shape_ok(h, cap, gx, gy, gz) || max_units < 1 ||
      (counters != nullptr &&
       counters_len < static_cast<long long>(kCountCounters) * blocks * kWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(t_xyz, t_count, q_count, h, cap, boxes, units, max_units, st);
  if (err != 0) return err;
  const auto kernel = counters != nullptr ? grid_count_kernel<true> : grid_count_kernel<false>;
  kernel<<<blocks, kThreads, 0, st>>>(t_xyz, reinterpret_cast<const float4*>(boxes), t_count,
                                      q_xyz, q_idx, q_ok, units, max_units, cap, gx, gy, gz,
                                      r2, aligned16(t_xyz, cap), sub, out, counters);
  return static_cast<int>(cudaGetLastError());
}

// Kernel J: values (P,) f32, the value of each target point, read in place
// through t_idx (h, cap) i64 (each filled slot's point index); recips
// (n_sigma <= 64,) f32 in host memory, f32(1 / (2 s^2)) of each sigma,
// passed by value; out (nq, n_sigma) f32 at the answered rows. The
// pre-pass and the radius kernel (kSigLane sigmas a group of its grid),
// boxes, units and counters as kernel H's.
extern "C" int mm_grid_smooth(const float* t_xyz, const long long* t_idx, const int* t_count,
                              const float* values, const float* q_xyz,
                              const long long* q_idx, const unsigned char* q_ok,
                              const int* q_count, int h, int cap, int gx, int gy, int gz,
                              float r2, const float* recips, int n_sigma, float* boxes,
                              int* units, int max_units, float* out, long long* counters,
                              long long counters_len, void* stream) {
  if (n_sigma < 1 || n_sigma > kMaxSigma || values == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmoothOp op{};
  for (int s = 0; s < n_sigma; ++s) op.recips.v[s] = recips[s];
  op.n_sigma = n_sigma;
  op.values = values;
  op.out = out;
  return launch_radius(op, (n_sigma + kSigLane - 1) / kSigLane, t_xyz, t_idx, t_count, q_xyz,
                       q_idx, q_ok, q_count, h, cap, gx, gy, gz, r2, boxes, units, max_units,
                       counters, counters_len, stream);
}

// Kernel K: 1 <= k <= 26; exclude_self 0 or 1; idx_out (nq, k) i32, d2_out
// (nq, k) f32, valid_out (nq, k) bool at the answered rows. The pre-pass
// (the target's boxes into `boxes`, the units into `units`) and the
// selection as kernel G's.
extern "C" int mm_grid_knn(const float* t_xyz, const long long* t_idx, const int* t_count,
                           const float* q_xyz, const long long* q_idx,
                           const unsigned char* q_ok, const int* q_count, int h, int cap,
                           int gx, int gy, int gz, float r2, int k, int exclude_self, int n_p,
                           float* boxes, int* units, int max_units, int* idx_out,
                           float* d2_out, unsigned char* valid_out, long long* counters,
                           long long counters_len, void* stream) {
  if (k < 1 || k > kK || !grid_shape_ok(h, cap, gx, gy, gz) || max_units < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(t_xyz, t_count, q_count, h, cap, boxes, units, max_units, st);
  if (err != 0) return err;
  return launch_select(KnnSel{t_idx, n_p, k, exclude_self, r2, idx_out, d2_out, valid_out},
                       t_xyz, boxes, t_count, q_xyz, q_idx, q_ok, units, max_units, cap, gx,
                       gy, gz, counters, counters_len, st);
}

// Kernel L's sweep route: values (P, channels) f32, 1 <= channels <= 16,
// the values of each target point, read in place through t_idx (h, cap)
// i64; is_max 0 (sum) or 1 (max); count_out (nq,) i32 and out (nq,
// channels) f32 at the answered rows. The pre-pass, then the sum on the
// radius kernel (ReduceOp) or the max on grid_max_kernel, each of width 1,
// 6 or 9 where channels is one of them, else of any width up to 16; boxes
// and units as kernel H's; counters: null, or (counters_len,) i64
// receiving 5 counts a warp (the sum, grid_radius_kernel's) or 8 (the max,
// grid_max_kernel's).
extern "C" int mm_grid_reduce(const float* t_xyz, const long long* t_idx, const int* t_count,
                              const float* values, int channels, int is_max, const float* q_xyz,
                              const long long* q_idx, const unsigned char* q_ok,
                              const int* q_count, int h, int cap, int gx, int gy, int gz,
                              float r2, float* boxes, int* units, int max_units,
                              int* count_out, float* out, long long* counters,
                              long long counters_len, void* stream) {
  if (channels < 1 || channels > kMaxChannels || values == nullptr ||
      static_cast<long long>(kNbr) * cap >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!is_max) {
    const auto sum = [&](auto op) {
      return launch_radius(op, 1, t_xyz, t_idx, t_count, q_xyz, q_idx, q_ok, q_count, h, cap, gx,
                           gy, gz, r2, boxes, units, max_units, counters, counters_len, stream);
    };
    switch (channels) {
      case 1: return sum(ReduceOp<1>{values, channels, count_out, out});
      case 6: return sum(ReduceOp<6>{values, channels, count_out, out});
      case 9: return sum(ReduceOp<9>{values, channels, count_out, out});
      default: return sum(ReduceOp<0>{values, channels, count_out, out});
    }
  }
  const int blocks = max_units < 1 ? 0 : (max_units + kWarps - 1) / kWarps;
  if (!grid_shape_ok(h, cap, gx, gy, gz) || max_units < 1 ||
      (counters != nullptr &&
       counters_len < static_cast<long long>(kCountCounters) * blocks * kWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(t_xyz, t_count, q_count, h, cap, boxes, units, max_units, st);
  if (err != 0) return err;
  const auto launch_max = [&](auto counted, auto plain) {
    const auto kernel = counters != nullptr ? counted : plain;
    kernel<<<blocks, kThreads, 0, st>>>(t_xyz, t_idx, reinterpret_cast<const float4*>(boxes),
                                        t_count, values, channels, kNbr * cap, q_xyz, q_idx,
                                        q_ok, units, max_units, cap, gx, gy, gz, r2,
                                        aligned16(t_xyz, cap), count_out, out, counters);
    return static_cast<int>(cudaGetLastError());
  };
  switch (channels) {
    case 1: return launch_max(grid_max_kernel<1, true>, grid_max_kernel<1, false>);
    case 6: return launch_max(grid_max_kernel<6, true>, grid_max_kernel<6, false>);
    case 9: return launch_max(grid_max_kernel<9, true>, grid_max_kernel<9, false>);
    default: return launch_max(grid_max_kernel<0, true>, grid_max_kernel<0, false>);
  }
}

// Kernel L's list route: q (nq, 3) f32, each query answered (no query
// grid); values, channels and is_max as mm_grid_reduce's; boxes the
// pre-pass's tile boxes of the target grid (mm_grid_pack's, for its filled
// tiles); inv_cell the float32 value of 1 / the target grid's cell edge;
// count_out (nq,) i32, out (nq, channels) f32. One launch, a warp a query,
// of width 1, 6 or 9 where channels is one of them, else of any width up
// to 16.
extern "C" int mm_grid_reduce_list(const float* t_xyz, const long long* t_idx,
                                   const int* t_count, const float* boxes, const float* values,
                                   int channels, int is_max, const float* q, int nq, int h,
                                   int cap, int gx, int gy, int gz, float inv_cell, float r2,
                                   int* count_out, float* out, void* stream) {
  if (channels < 1 || channels > kMaxChannels || values == nullptr || boxes == nullptr ||
      nq < 1 || !grid_shape_ok(h, cap, gx, gy, gz) ||
      static_cast<long long>(kNbr) * cap >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (nq + kWarps - 1) / kWarps;
  const auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t_xyz, t_idx, t_count, reinterpret_cast<const float4*>(boxes), values, channels, q, nq,
        cap, gx, gy, gz, inv_cell, r2, count_out, out);
    return static_cast<int>(cudaGetLastError());
  };
  if (is_max) {
    return channels == 1 ? run(grid_reduce_list_kernel<true, 1>)
                         : run(grid_reduce_list_kernel<true, 0>);
  }
  switch (channels) {
    case 1: return run(grid_reduce_list_kernel<false, 1>);
    case 6: return run(grid_reduce_list_kernel<false, 6>);
    case 9: return run(grid_reduce_list_kernel<false, 9>);
    default: return run(grid_reduce_list_kernel<false, 0>);
  }
}
