// Vert-hull convex narrowphase for Hopper (sm_90a): one staged support
// sweep with its witness points, and two epilogues that return it as one
// contact point (hull pair) or as a 4-point manifold of side-1 corners
// (box against hull).
//
// Replaces robogym_tpu/physics/collision/convex_kernel.py:_hull_kernel_loc
// (robogym_hull_pair) and :_manifold_kernel_loc (robogym_hull_manifold),
// with their shared _world_from_loc, _sweep_witness and _manifold_body, and
// their world-vertex twins :_hull_kernel (robogym_hull_pair_world) and
// :_manifold_kernel (robogym_hull_manifold_world), which read verts the
// caller has already placed in the world and skip the transform.
//
// Bound on this card: a pair reads its verts (3 x V floats a side, at most
// 64 verts) and, for the local entries, its two poses, under 2 KB, and
// writes under 100 bytes; the sweep evaluates about 35 directions against
// every vert of both sides, about 6 * 35 * (V1 + V2) flops. Both bounds
// are a few microseconds at the main path's sizes. Measured stage by stage
// on an H100 (PERF.md), the kernels are bound by each pair's serial chain
// of square roots, divisions, shuffle rounds and re-reads.
//
// Direction selection emulates the JAX package's bfloat16 dots as the
// plain version does: centered verts and the direction rounded to bf16,
// the three exact products summed in float32, the sum rounded to bf16. The
// library is built with -fmad=false, so every other float32 expression
// rounds as the plain version's elementwise operations do and the kernels
// pick the same direction except on near-ties.
//
// The sweep (`group_sweep`): a group of kGroup = 8 lanes per pair, four
// pairs a warp, directions across the lanes. Each vert is placed once and
// its bf16 centered copy staged in shared memory as a float4 (a quarter
// warp reads one pair's vert, a broadcast; a pair's stride is odd, so the
// quarters read disjoint banks). The group is 4 direction slots times 2
// parts of the verts: lane j takes slot j % 4's directions over every
// other vert from j / 4, so that each shared load serves several
// directions. Stage A (the icosahedron's 12, the centre line, the DX
// extras) gives a slot 4 or 5 directions; each ring of 8 candidates gives
// it 2, lane j making candidate j. A lane keeps its extremes in registers
// and one xor shuffle joins the two parts. Rounding to bf16 is monotone and
// odd, so max_v bf(dot_v) = bf(max_v dot_v) and max_v -bf(dot_v) =
// -bf(min_v dot_v): each side's support is the float32 extreme rounded
// once, bit for bit the plain version's. Each stage ends in one argmin over
// the group (3 shuffle rounds, ties to the lower index as torch.argmin).
// The witnesses run across the group, lane j holding verts j, j + 8, ...;
// a world position is placed again from the operands where one is needed,
// by the staging's expression, so it has the same bits.
//
// The epilogues: the hull pair (D, G) writes the contact's ten floats, a
// lane at a time; the manifold (C, H) takes the hull's support bounds
// along two tangents and picks side 1's 4 deepest corners, across the
// group.

#include <cuda_bf16.h>
#include <math_constants.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e10f;
constexpr float kTol = 5e-3f;   // lateral tolerance of the manifold corners
constexpr int kRingN = 8;
constexpr int kDirs = 12;        // icosahedron directions; the table holds them,
                                 // then the ring's (cos, sin) pairs
constexpr int kMaxVerts = 64;    // a side
constexpr int kGroup = 8;        // lanes a pair
constexpr int kParts = 2;        // ... as kParts parts of a pair's verts
constexpr int kSlots = kGroup / kParts;   // ... times kSlots direction slots
constexpr int kPairsPerBlock = 16;
constexpr int kThreads = kGroup * kPairsPerBlock;
constexpr int kNone = 0x7fffffff;  // index of no direction or corner
static_assert(kGroup == kRingN && kParts == 2, "a ring's candidates: two a lane, one made");
static_assert(32 % kGroup == 0, "groups tile a warp");

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 ld3(const float* p) { return V3{p[0], p[1], p[2]}; }

__device__ __forceinline__ V3 bf3(V3 a) { return V3{bf(a.x), bf(a.y), bf(a.z)}; }

// a side's pose: row-major rotation and origin (not read for world verts)
struct Pose {
  float r[9];
  V3 o;
};

template <bool kWorld>
__device__ __forceinline__ Pose load_pose(const float* xm, const float* xp) {
  Pose p{};
  if constexpr (!kWorld) {
#pragma unroll
    for (int i = 0; i < 9; ++i) p.r[i] = xm[i];
    p.o = ld3(xp);
  }
  return p;
}

// world position of vert idx of a side's bank v (3 x V): as read (kWorld)
// or placed by the pose. Every vert of the bank counts (the driver parks
// padding at the hull's center).
template <bool kWorld>
__device__ __forceinline__ V3 place(const float* v, int V, int idx, const Pose& p) {
  const float l0 = v[idx], l1 = v[V + idx], l2 = v[2 * V + idx];
  if constexpr (kWorld) {
    return V3{l0, l1, l2};
  } else {
    return V3{p.o.x + ((p.r[0] * l0 + p.r[1] * l1) + p.r[2] * l2),
              p.o.y + ((p.r[3] * l0 + p.r[4] * l1) + p.r[5] * l2),
              p.o.z + ((p.r[6] * l0 + p.r[7] * l1) + p.r[8] * l2)};
  }
}

__device__ __forceinline__ V3 centered(V3 w, V3 c) {
  return V3{bf(w.x - c.x), bf(w.y - c.y), bf(w.z - c.z)};
}

__device__ __forceinline__ V3 scaled(V3 a, float inv_plus) {
  return V3{a.x / inv_plus, a.y / inv_plus, a.z / inv_plus};
}

// the (1,0,0)/(0,1,0) helper pick and the tangent t1 = cross(n, helper)
__device__ __forceinline__ V3 tangent(V3 n) {
  const bool small = fabsf(n.x) < 0.5f;
  const V3 h{small ? 1.0f : 0.0f, small ? 0.0f : 1.0f, 0.0f};
  return cross3(n, h);
}

// float4s a pair's staged verts take: an odd count, so that the four pairs
// of a warp read disjoint banks when each of its quarters reads a float4
__host__ __device__ __forceinline__ int pair_stride(int V1, int V2) { return (V1 + V2) | 1; }

// The group helpers below shuffle within aligned groups of kGroup lanes.
// Every lane of the warp takes part in every shuffle, so they name the full
// warp and compile to single instructions, not to the sequences of a
// partial mask.

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the same bits in every lane: float addition commutes
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the group's least (v, i) in every lane, ties to the lower index
__device__ __forceinline__ void group_argmin(float& v, int& i) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// a of the group's lane `src`
__device__ __forceinline__ V3 group_take(V3 a, int src) {
  const int l = (int)(threadIdx.x & 31 & ~(kGroup - 1)) | src;
  return V3{__shfl_sync(kFull, a.x, l), __shfl_sync(kFull, a.y, l),
            __shfl_sync(kFull, a.z, l)};
}

// the float32 dot of a bf16-valued direction with a staged vert, unrounded
__device__ __forceinline__ float dot_raw(V3 db, float4 c) {
  return (db.x * c.x + db.y * c.y) + db.z * c.z;
}

// lane j of the group places verts j, j + kGroup, ... of a side by its
// pose (xm, xp) and stages their bf16 centered copies
template <bool kWorld>
__device__ __forceinline__ void stage(int lane, const float* v, const float* xm,
                                      const float* xp, V3 c, int V, float4* cv) {
  const Pose pose = load_pose<kWorld>(xm, xp);
  for (int i = lane; i < V; i += kGroup) {
    const V3 x = centered(place<kWorld>(v, V, i, pose), c);
    cv[i] = make_float4(x.x, x.y, x.z, 0.0f);
  }
}

// the float32 maximum of side 1's dots and the minimum of side 2's with
// each of P bf16-valued directions, over the pair's staged verts: this
// lane's part of them (every kParts-th, from `part`), then the group's
// (max and min are exact: both parts get the same bits)
template <int P>
__device__ __forceinline__ void extremes(int lane, const float4* cv, int V1, int V2,
                                         const V3 (&db)[P], float (&hi)[P], float (&lo)[P]) {
  const int part = lane / kSlots;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    hi[q] = -CUDART_INF_F;
    lo[q] = CUDART_INF_F;
  }
#pragma unroll 2
  for (int i = part; i < V1; i += kParts) {
    const float4 c = cv[i];
#pragma unroll
    for (int q = 0; q < P; ++q) hi[q] = fmaxf(hi[q], dot_raw(db[q], c));
  }
#pragma unroll 2
  for (int i = V1 + part; i < V1 + V2; i += kParts) {
    const float4 c = cv[i];
#pragma unroll
    for (int q = 0; q < P; ++q) lo[q] = fminf(lo[q], dot_raw(db[q], c));
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    hi[q] = fmaxf(hi[q], __shfl_xor_sync(kFull, hi[q], kSlots));
    lo[q] = fminf(lo[q], __shfl_xor_sync(kFull, lo[q], kSlots));
  }
}

// the selection separation along a direction d from its extremes, each
// rounded once, and dot3(d, dc)
__device__ __forceinline__ float sel_sep(float hi, float lo, float ddc) {
  return (bf(hi) + -bf(lo)) + ddc;
}

// stage A's direction k < 13 + DX: the icosahedron's, the centre line, the
// extras
__device__ __forceinline__ V3 stage_a_dir(int k, const float* tab, V3 c1, V3 c2,
                                          const float* xd) {
  if (k < kDirs) return ld3(tab + 3 * k);
  if (k == kDirs) {
    const V3 e{c2.x - c1.x, c2.y - c1.y, c2.z - c1.z};
    return scaled(e, sqrtf(dot3(e, e)) + 1e-12f);
  }
  return ld3(xd + 3 * (k - kDirs - 1));
}

// centroid of the verts of a side that reach its (negated) support along
// nb; lane j scores verts j, j + kGroup, ... and places those that do
template <bool kWorld>
__device__ V3 group_witness(int lane, const float4* cv, const float* v, const Pose& pose,
                            int V, V3 nb, bool neg) {
  float m = -CUDART_INF_F;
  for (int i = lane; i < V; i += kGroup) {
    const float d = bf(dot_raw(nb, cv[i]));
    m = fmaxf(m, neg ? -d : d);
  }
  const float dmax = group_max(m);
  float cnt = 0.0f;
  for (int i = lane; i < V; i += kGroup) {
    const float d = bf(dot_raw(nb, cv[i]));
    cnt += (neg ? -d : d) >= dmax ? 1.0f : 0.0f;
  }
  const float w = 1.0f / group_sum(cnt);
  V3 acc{0.0f, 0.0f, 0.0f};
  for (int i = lane; i < V; i += kGroup) {
    const float d = bf(dot_raw(nb, cv[i]));
    if ((neg ? -d : d) >= dmax) {
      const V3 x = place<kWorld>(v, V, i, pose);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
    }
  }
  return V3{group_sum(acc.x), group_sum(acc.y), group_sum(acc.z)};
}

// v1, v2: local verts with their poses xm, xp, or world verts with the pose
// pointers null (the world entries)
struct Args {
  const float *v1, *xm1, *xp1, *v2, *xm2, *xp2, *c1, *c2, *xd, *tab;
  int BK, V1, V2, DXp, DX;
};

// One pair's group: its place, its operands and its staged verts
struct Pair {
  bool live;       // a pair of the call; a group past the last pair repeats
                   // it (every lane takes part in every shuffle) and writes nothing
  int lane;        // this lane's index among its pair's
  size_t p;        // the pair whose operands the group reads
  float4* cv;      // side 1's staged verts, then side 2's
  V3 c1, c2;
  const float *v1, *v2, *xm1, *xp1, *xm2, *xp2, *xd;
};

// the group's pair, with its verts staged; ends in the warp's barrier
template <bool kWorld>
__device__ __forceinline__ Pair pair_of(const Args& a, float4* cvs) {
  const int pb = threadIdx.x / kGroup;   // the pair's place in the block
  const int pair = blockIdx.x * kPairsPerBlock + pb;
  Pair q;
  q.live = pair < a.BK;
  q.lane = threadIdx.x % kGroup;
  q.p = q.live ? pair : a.BK - 1;
  q.cv = cvs + pb * pair_stride(a.V1, a.V2);
  q.c1 = ld3(a.c1 + 3 * q.p);
  q.c2 = ld3(a.c2 + 3 * q.p);
  q.v1 = a.v1 + q.p * 3 * a.V1;
  q.v2 = a.v2 + q.p * 3 * a.V2;
  q.xm1 = kWorld ? nullptr : a.xm1 + 9 * q.p;
  q.xp1 = kWorld ? nullptr : a.xp1 + 3 * q.p;
  q.xm2 = kWorld ? nullptr : a.xm2 + 9 * q.p;
  q.xp2 = kWorld ? nullptr : a.xp2 + 3 * q.p;
  q.xd = a.xd + q.p * a.DXp * 3;
  stage<kWorld>(q.lane, q.v1, q.xm1, q.xp1, q.c1, a.V1, q.cv);
  stage<kWorld>(q.lane, q.v2, q.xm2, q.xp2, q.c2, a.V2, q.cv + a.V1);
  __syncwarp();
  return q;
}

struct Sweep {
  V3 n, p1, p2;
  float dist;
};

// The pair's sweep: the normal n, the witnesses p1 and p2 and the depth,
// the same bits in every lane of the group. P: stage A's directions a lane
// in one pass over its part of the verts.
template <bool kWorld, int P>
__device__ __forceinline__ Sweep group_sweep(const Args& a, const Pair& q) {
  const int lane = q.lane, V1 = a.V1, V2 = a.V2;
  const float4* cv = q.cv;
  const V3 c1 = q.c1, c2 = q.c2;

  // stage A: the lanes of slot j < kSlots take directions j, j + kSlots,
  // ... in ascending order (the strict < keeps the lowest index of a tie
  // within the lane), each over its part of the verts
  const int slot = lane % kSlots;
  const V3 dc{c1.x - c2.x, c1.y - c2.y, c1.z - c2.z};
  const int nA = kDirs + 1 + a.DX;
  float best = CUDART_INF_F;
  int bi = kNone;
  for (int base = 0; base < nA; base += P * kSlots) {
    V3 db[P];
    float ddc[P], hi[P], lo[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = base + slot + j * kSlots;
      const V3 d = k < nA ? stage_a_dir(k, a.tab, c1, c2, q.xd) : V3{0.0f, 0.0f, 0.0f};
      db[j] = bf3(d);
      ddc[j] = dot3(d, dc);
    }
    extremes<P>(lane, cv, V1, V2, db, hi, lo);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = base + slot + j * kSlots;
      const float s = sel_sep(hi[j], lo[j], ddc[j]);
      if (k < nA && s < best) {
        best = s;
        bi = k;
      }
    }
  }
  group_argmin(best, bi);
  // the winner, made again by every lane of the group (the same bits)
  V3 n = bi < nA ? stage_a_dir(bi, a.tab, c1, c2, q.xd) : V3{0.0f, 0.0f, 1.0f};

  // two rings of kRingN candidates around n: lane j makes candidate j and
  // sweeps candidates slot and slot + kSlots over its part of the verts; a
  // ring replaces n only when strictly better
  const float radii[2] = {0.3f, 0.08f};
  const float cs = a.tab[3 * kDirs + 2 * lane], sn = a.tab[3 * kDirs + 2 * lane + 1];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float radius = radii[ri];
    V3 t1 = tangent(n);
    t1 = scaled(t1, sqrtf(dot3(t1, t1)) + 1e-12f);
    const V3 t2 = cross3(n, t1);
    V3 u{n.x + radius * (cs * t1.x + sn * t2.x), n.y + radius * (cs * t1.y + sn * t2.y),
         n.z + radius * (cs * t1.z + sn * t2.z)};
    u = scaled(u, sqrtf(dot3(u, u)) + 1e-12f);
    const V3 o = group_take(u, lane ^ kSlots);
    const V3 uq[2] = {lane < kSlots ? u : o, lane < kSlots ? o : u};
    const V3 ub[2] = {bf3(uq[0]), bf3(uq[1])};
    float hi[2], lo[2];
    extremes<2>(lane, cv, V1, V2, ub, hi, lo);
    float s = sel_sep(hi[0], lo[0], dot3(uq[0], dc));
    int k = slot;
    const float s1 = sel_sep(hi[1], lo[1], dot3(uq[1], dc));
    if (s1 < s) {
      s = s1;
      k = slot + kSlots;
    }
    group_argmin(s, k);
    const V3 un = group_take(u, k);
    if (s < best) {
      best = s;
      n = un;
    }
  }

  // the poses again, not kept in registers through the sweep
  const Pose pose1 = load_pose<kWorld>(q.xm1, q.xp1), pose2 = load_pose<kWorld>(q.xm2, q.xp2);
  const V3 nbf = bf3(n);
  Sweep r;
  r.n = n;
  r.p1 = group_witness<kWorld>(lane, cv, q.v1, pose1, V1, nbf, false);
  r.p2 = group_witness<kWorld>(lane, cv + V1, q.v2, pose2, V2, nbf, true);
  const V3 dp{r.p1.x - r.p2.x, r.p1.y - r.p2.y, r.p1.z - r.p2.z};
  r.dist = -dot3(n, dp);
  return r;
}

// Hull pair (D, G): the contact's ten floats (dist, pos = the witnesses'
// midpoint, n, p2), lane j writing those at j and j + kGroup
template <bool kWorld, int P>
__global__ void __launch_bounds__(kThreads)
hull_pair_group_kernel(Args a, float* __restrict__ dist, float* __restrict__ pos,
                       float* __restrict__ nrm, float* __restrict__ p2o) {
  extern __shared__ float4 cvs[];
  const Pair q = pair_of<kWorld>(a, cvs);
  const Sweep r = group_sweep<kWorld, P>(a, q);
  if (!q.live) return;
  const V3 mid{0.5f * (r.p1.x + r.p2.x), 0.5f * (r.p1.y + r.p2.y), 0.5f * (r.p1.z + r.p2.z)};
  const float out[10] = {r.dist, mid.x, mid.y, mid.z, r.n.x, r.n.y, r.n.z, r.p2.x, r.p2.y, r.p2.z};
  const size_t p = q.p;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    if (k % kGroup != q.lane) continue;
    float* dst = k == 0 ? dist + p : k < 4 ? pos + 3 * p + (k - 1)
                 : k < 7 ? nrm + 3 * p + (k - 4) : p2o + 3 * p + (k - 7);
    *dst = out[k];
  }
}

// Manifold (C, H): the hull's support bounds along the tangents, each
// side-1 corner's depth, and the 4 deepest corners
template <bool kWorld, int P>
__global__ void __launch_bounds__(kThreads)
hull_manifold_kernel(Args a, float* __restrict__ dist4, float* __restrict__ pos4,
                     float* __restrict__ nrm) {
  extern __shared__ float4 cvs[];
  const Pair q = pair_of<kWorld>(a, cvs);
  const Sweep r = group_sweep<kWorld, P>(a, q);
  const int lane = q.lane, V1 = a.V1, V2 = a.V2;
  const bool live = q.live;
  const size_t p = q.p;
  const float4* cv = q.cv;
  const float* v1 = q.v1;
  const V3 c2 = q.c2, n = r.n, p1 = r.p1, p2 = r.p2;
  const float dist = r.dist;
  const Pose pose1 = load_pose<kWorld>(q.xm1, q.xp1);

  // tangent directions and the hull's support bound along each
  V3 t1 = tangent(n);
  t1 = scaled(t1, sqrtf(dot3(t1, t1)) + 1e-24f);
  const V3 t2 = cross3(n, t1);
  const V3 td[4] = {t1, V3{-t1.x, -t1.y, -t1.z}, t2, V3{-t2.x, -t2.y, -t2.z}};
  float bound[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const V3 db = bf3(td[j]);
    float m = -CUDART_INF_F;
    for (int i = lane; i < V2; i += kGroup) m = fmaxf(m, dot_raw(db, cv[V1 + i]));
    bound[j] = bf(group_max(m)) + dot3(td[j], c2);
  }

  // each side-1 corner's depth below the plane through p2, BIG when it
  // lies laterally outside the hull's footprint; lane j holds corners j,
  // j + kGroup, ...
  constexpr int kCorners = kMaxVerts / kGroup;
  const V3 mn{-n.x, -n.y, -n.z};
  float cd[kCorners];
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    const int i = lane + kGroup * k;
    cd[k] = CUDART_INF_F;
    if (i < V1) {
      const V3 cw = place<kWorld>(v1, V1, i, pose1);
      const V3 rel{cw.x - p2.x, cw.y - p2.y, cw.z - p2.z};
      bool ok = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) ok = ok && (dot3(cw, td[j]) <= bound[j] + kTol);
      cd[k] = ok ? dot3(rel, mn) : kBig;
    }
  }

  // the 4 deepest corners, ties to the lower corner index; lane j keeps
  // pick j
  float dq = 0.0f;
  int iq = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float bv = CUDART_INF_F;
    int bc = kNone;
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      if (cd[k] < bv) {
        bv = cd[k];
        bc = lane + kGroup * k;
      }
    }
    group_argmin(bv, bc);
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      if (lane + kGroup * k == bc) cd[k] = CUDART_INF_F;
    }
    if (lane == j) {
      dq = bv;
      iq = bc;
    }
  }

  if (live && lane < 4) {
    float d = dq;
    const V3 cw = place<kWorld>(v1, V1, iq, pose1);
    V3 pq{cw.x - (0.5f * d) * n.x, cw.y - (0.5f * d) * n.y, cw.z - (0.5f * d) * n.z};
    if (lane == 3 && d >= kBig / 2.0f) {
      d = dist;
      pq = V3{0.5f * (p1.x + p2.x), 0.5f * (p1.y + p2.y), 0.5f * (p1.z + p2.z)};
    }
    dist4[4 * p + lane] = d;
    pos4[12 * p + 3 * lane + 0] = pq.x;
    pos4[12 * p + 3 * lane + 1] = pq.y;
    pos4[12 * p + 3 * lane + 2] = pq.z;
  }
  if (live && lane == 0) {
    nrm[3 * p + 0] = n.x;
    nrm[3 * p + 1] = n.y;
    nrm[3 * p + 2] = n.z;
  }
}

int check(int BK, int V1, int V2, int DXp, int DX) {
  if (BK < 0 || V1 < 1 || V2 < 1 || V1 > 64 || V2 > 64 || DX < 0 || DX > DXp) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

using PairFn = void (*)(Args, float*, float*, float*, float*);
using ManifoldFn = void (*)(Args, float*, float*, float*);

// a kernel's instance for stage A's 13 + DX directions: four a slot up to
// 16 of them, else five a slot in as many passes as they need
template <class Fn>
Fn by_stage_a(int DX, Fn four, Fn five) {
  return kDirs + 1 + DX <= 4 * kSlots ? four : five;
}

template <bool kWorld>
PairFn pair_fn(int DX) {
  return by_stage_a<PairFn>(DX, hull_pair_group_kernel<kWorld, 4>,
                            hull_pair_group_kernel<kWorld, 5>);
}

template <bool kWorld>
ManifoldFn manifold_fn(int DX) {
  return by_stage_a<ManifoldFn>(DX, hull_manifold_kernel<kWorld, 4>,
                                hull_manifold_kernel<kWorld, 5>);
}

// a block's staged verts
size_t block_smem(int V1, int V2) {
  return sizeof(float4) * kPairsPerBlock * pair_stride(V1, V2);
}

template <class Fn, class... Out>
int launch(Fn fn, const Args& a, cudaStream_t stream, Out... out) {
  if (int e = check(a.BK, a.V1, a.V2, a.DXp, a.DX)) return e;
  if (a.BK == 0) return 0;
  const int grid = (a.BK + kPairsPerBlock - 1) / kPairsPerBlock;
  fn<<<grid, kThreads, block_smem(a.V1, a.V2), stream>>>(a, out...);
  return (int)cudaGetLastError();
}

// a kernel's layout for V1, V2 into out: shared memory a block (bytes),
// registers a thread, blocks an SM by the occupancy calculator, threads a
// block, pairs a block
template <class Fn>
int layout(Fn fn, int V1, int V2, int* out) {
  const int smem = (int)block_smem(V1, V2);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = smem;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = kPairsPerBlock;
  return 0;
}

}  // namespace

extern "C" int robogym_hull_pair(const float* v1l, const float* xm1, const float* xp1,
                                 const float* v2l, const float* xm2, const float* xp2,
                                 const float* c1, const float* c2, const float* xd,
                                 const float* tab, float* dist, float* pos, float* n, float* p2,
                                 int BK, int V1, int V2, int DXp, int DX, cudaStream_t stream) {
  const Args a{v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch(pair_fn<false>(DX), a, stream, dist, pos, n, p2);
}

extern "C" int robogym_hull_pair_world(const float* v1, const float* v2, const float* c1,
                                       const float* c2, const float* xd, const float* tab,
                                       float* dist, float* pos, float* n, float* p2, int BK,
                                       int V1, int V2, int DXp, int DX, cudaStream_t stream) {
  const Args a{v1, nullptr, nullptr, v2, nullptr, nullptr, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch(pair_fn<true>(DX), a, stream, dist, pos, n, p2);
}

extern "C" int robogym_hull_manifold(const float* v1l, const float* xm1, const float* xp1,
                                     const float* v2l, const float* xm2, const float* xp2,
                                     const float* c1, const float* c2, const float* xd,
                                     const float* tab, float* dist4, float* pos4, float* n,
                                     int BK, int V1, int V2, int DXp, int DX,
                                     cudaStream_t stream) {
  if (V1 < 4) return (int)cudaErrorInvalidValue;
  const Args a{v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch(manifold_fn<false>(DX), a, stream, dist4, pos4, n);
}

extern "C" int robogym_hull_manifold_world(const float* v1, const float* v2, const float* c1,
                                           const float* c2, const float* xd, const float* tab,
                                           float* dist4, float* pos4, float* n, int BK, int V1,
                                           int V2, int DXp, int DX, cudaStream_t stream) {
  if (V1 < 4) return (int)cudaErrorInvalidValue;
  const Args a{v1, nullptr, nullptr, v2, nullptr, nullptr, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch(manifold_fn<true>(DX), a, stream, dist4, pos4, n);
}

// The layout of a hull kernel for V1, V2 and DX into out (`layout`). kind:
// 0 the manifold (C), 1 its world-vertex instance (H), 2 the hull pair (D),
// 3 its world-vertex instance (G). Returns a CUDA error.
extern "C" int robogym_hull_info(int kind, int V1, int V2, int DX, int* out) {
  if (int e = check(0, V1, V2, DX, DX)) return e;
  switch (kind) {
    case 0: return layout(manifold_fn<false>(DX), V1, V2, out);
    case 1: return layout(manifold_fn<true>(DX), V1, V2, out);
    case 2: return layout(pair_fn<false>(DX), V1, V2, out);
    case 3: return layout(pair_fn<true>(DX), V1, V2, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
