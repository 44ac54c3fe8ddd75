// Vert-hull convex narrowphase for Hopper (sm_90a): the staged support
// sweep with its witness points, returned as one contact point (hull pair)
// or as a 4-point manifold of side-1 corners (box against hull).
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
// are a few microseconds at the main path's sizes; what bounds a simple
// kernel is the chain of 35 dependent warp reductions per pair.
//
// Design: one warp per pair. Lane l holds verts l and l + 32 of each side,
// read as world verts or rotated and translated into the world frame in
// registers (a template flag); every direction's support value is a warp
// max by __shfl_xor_sync, so the whole sweep, the rings and the witness
// extraction run without shared memory or barriers. Direction selection
// emulates the JAX package's bfloat16 dots as the plain version does:
// centered verts and the direction rounded to bf16, the three exact
// products summed in float32, the sum rounded to bf16. The library is built with -fmad=false, so every other float32
// expression rounds as the plain version's elementwise operations do and
// the kernel picks the same direction except on near-ties.

#include <cuda_bf16.h>
#include <math_constants.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e10f;
constexpr float kTol = 5e-3f;   // lateral tolerance of the manifold corners
constexpr int kRingN = 8;
constexpr int kDirs = 12;        // icosahedron directions; the table holds them,
                                 // then the ring's (cos, sin) pairs

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 ld3(const float* p) { return V3{p[0], p[1], p[2]}; }

__device__ __forceinline__ V3 bf3(V3 a) { return V3{bf(a.x), bf(a.y), bf(a.z)}; }

// A lane's two verts of one side: world position and bf16 centered copy.
struct Side {
  V3 w[2];
  V3 cv[2];
  bool ok[2];
};

// kWorld: v holds world verts and xm, xp are not read; otherwise v holds
// local verts, placed by the row-major rotation xm and the origin xp. Every
// vert of the bank counts (the driver parks padding at the hull's center).
template <bool kWorld>
__device__ void load_side(const float* v, const float* xm, const float* xp, V3 c, int V,
                          int lane, Side& s) {
  float R[9] = {};
  V3 o{0.0f, 0.0f, 0.0f};
  if constexpr (!kWorld) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = xm[i];
    o = ld3(xp);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int idx = lane + 32 * k;
    s.ok[k] = idx < V;
    if (s.ok[k]) {
      const float l0 = v[idx], l1 = v[V + idx], l2 = v[2 * V + idx];
      V3 w{l0, l1, l2};
      if constexpr (!kWorld) {
        w = V3{o.x + ((R[0] * l0 + R[1] * l1) + R[2] * l2),
               o.y + ((R[3] * l0 + R[4] * l1) + R[5] * l2),
               o.z + ((R[6] * l0 + R[7] * l1) + R[8] * l2)};
      }
      s.w[k] = w;
      s.cv[k] = V3{bf(w.x - c.x), bf(w.y - c.y), bf(w.z - c.z)};
    } else {
      s.w[k] = V3{0.0f, 0.0f, 0.0f};
      s.cv[k] = s.w[k];
    }
  }
}

// bf16 selection dot of a bf16-valued direction with a lane's vert k
__device__ __forceinline__ float sel_dot(const Side& s, int k, V3 db) {
  return bf((db.x * s.cv[k].x + db.y * s.cv[k].y) + db.z * s.cv[k].z);
}

// max over the side's verts of the (negated) selection dots
__device__ __forceinline__ float support(const Side& s, V3 db, bool neg) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (s.ok[k]) {
      const float d = sel_dot(s, k, db);
      m = fmaxf(m, neg ? -d : d);
    }
  }
  return warp_max(m);
}

__device__ __forceinline__ float separation(const Side& s1, const Side& s2, V3 d, V3 dc) {
  const V3 db = bf3(d);
  return (support(s1, db, false) + support(s2, db, true)) + dot3(d, dc);
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

// centroid of the verts that reach the side's (negated) support along n
__device__ V3 witness(const Side& s, V3 nb, bool neg) {
  float d[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float v = sel_dot(s, k, nb);
    d[k] = neg ? -v : v;
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 2; ++k) if (s.ok[k]) m = fmaxf(m, d[k]);
  const float dmax = warp_max(m);
  bool on[2];
  float cnt = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    on[k] = s.ok[k] && d[k] >= dmax;
    cnt += on[k] ? 1.0f : 0.0f;
  }
  const float w = 1.0f / warp_sum(cnt);
  V3 acc{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float o = on[k] ? w : 0.0f;
    acc.x += o * s.w[k].x;
    acc.y += o * s.w[k].y;
    acc.z += o * s.w[k].z;
  }
  return V3{warp_sum(acc.x), warp_sum(acc.y), warp_sum(acc.z)};
}

struct Sweep {
  V3 n, p1, p2;
  float dist;
};

__device__ Sweep sweep(const Side& s1, const Side& s2, V3 c1, V3 c2, const float* xd, int DX,
                       const float* tab) {
  const V3 dc{c1.x - c2.x, c1.y - c2.y, c1.z - c2.z};
  float best = CUDART_INF_F;
  V3 n{0.0f, 0.0f, 1.0f};
  for (int j = 0; j < kDirs; ++j) {
    const V3 d = ld3(tab + 3 * j);
    const float s = separation(s1, s2, d, dc);
    if (s < best) {
      best = s;
      n = d;
    }
  }
  {
    const V3 e{c2.x - c1.x, c2.y - c1.y, c2.z - c1.z};
    const V3 d = scaled(e, sqrtf(dot3(e, e)) + 1e-12f);
    const float s = separation(s1, s2, d, dc);
    if (s < best) {
      best = s;
      n = d;
    }
  }
  for (int j = 0; j < DX; ++j) {
    const V3 d = ld3(xd + 3 * j);
    const float s = separation(s1, s2, d, dc);
    if (s < best) {
      best = s;
      n = d;
    }
  }
  const float radii[2] = {0.3f, 0.08f};
  const float* ring = tab + 3 * kDirs;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float radius = radii[ri];
    V3 t1 = tangent(n);
    t1 = scaled(t1, sqrtf(dot3(t1, t1)) + 1e-12f);
    const V3 t2 = cross3(n, t1);
    float sb = CUDART_INF_F;
    V3 nb = n;
    for (int k = 0; k < kRingN; ++k) {
      const float cs = ring[2 * k], sn = ring[2 * k + 1];
      V3 u{n.x + radius * (cs * t1.x + sn * t2.x), n.y + radius * (cs * t1.y + sn * t2.y),
           n.z + radius * (cs * t1.z + sn * t2.z)};
      u = scaled(u, sqrtf(dot3(u, u)) + 1e-12f);
      const float s = separation(s1, s2, u, dc);
      if (s < sb) {
        sb = s;
        nb = u;
      }
    }
    if (sb < best) {
      best = sb;
      n = nb;
    }
  }
  Sweep out;
  out.n = n;
  const V3 nbf = bf3(n);
  out.p1 = witness(s1, nbf, false);
  out.p2 = witness(s2, nbf, true);
  const V3 dp{out.p1.x - out.p2.x, out.p1.y - out.p2.y, out.p1.z - out.p2.z};
  out.dist = -dot3(n, dp);
  return out;
}

// v1, v2: local verts with their poses xm, xp, or world verts with the pose
// pointers null (the world entries)
struct Args {
  const float *v1, *xm1, *xp1, *v2, *xm2, *xp2, *c1, *c2, *xd, *tab;
  int BK, V1, V2, DXp, DX;
};

template <bool kWorld>
__device__ __forceinline__ bool pair_setup(const Args& a, int& w, int& lane, Side& s1, Side& s2,
                                           V3& c1, V3& c2) {
  w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  lane = threadIdx.x & 31;
  if (w >= a.BK) return false;
  c1 = ld3(a.c1 + 3 * (size_t)w);
  c2 = ld3(a.c2 + 3 * (size_t)w);
  const size_t p = (size_t)w;
  load_side<kWorld>(a.v1 + p * 3 * a.V1, kWorld ? nullptr : a.xm1 + 9 * p,
                    kWorld ? nullptr : a.xp1 + 3 * p, c1, a.V1, lane, s1);
  load_side<kWorld>(a.v2 + p * 3 * a.V2, kWorld ? nullptr : a.xm2 + 9 * p,
                    kWorld ? nullptr : a.xp2 + 3 * p, c2, a.V2, lane, s2);
  return true;
}

template <bool kWorld>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hull_pair_kernel(Args a, float* __restrict__ dist, float* __restrict__ pos, float* __restrict__ nrm,
                 float* __restrict__ p2o) {
  int w, lane;
  Side s1, s2;
  V3 c1, c2;
  if (!pair_setup<kWorld>(a, w, lane, s1, s2, c1, c2)) return;
  const Sweep r = sweep(s1, s2, c1, c2, a.xd + (size_t)w * a.DXp * 3, a.DX, a.tab);
  if (lane == 0) {
    dist[w] = r.dist;
    pos[3 * w + 0] = 0.5f * (r.p1.x + r.p2.x);
    pos[3 * w + 1] = 0.5f * (r.p1.y + r.p2.y);
    pos[3 * w + 2] = 0.5f * (r.p1.z + r.p2.z);
    nrm[3 * w + 0] = r.n.x;
    nrm[3 * w + 1] = r.n.y;
    nrm[3 * w + 2] = r.n.z;
    p2o[3 * w + 0] = r.p2.x;
    p2o[3 * w + 1] = r.p2.y;
    p2o[3 * w + 2] = r.p2.z;
  }
}

template <bool kWorld>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hull_manifold_kernel(Args a, float* __restrict__ dist4, float* __restrict__ pos4,
                     float* __restrict__ nrm) {
  int w, lane;
  Side s1, s2;
  V3 c1, c2;
  if (!pair_setup<kWorld>(a, w, lane, s1, s2, c1, c2)) return;
  const Sweep r = sweep(s1, s2, c1, c2, a.xd + (size_t)w * a.DXp * 3, a.DX, a.tab);
  const V3 n = r.n;

  // tangent directions and the hull's support bound along each
  V3 t1 = tangent(n);
  t1 = scaled(t1, sqrtf(dot3(t1, t1)) + 1e-24f);
  const V3 t2 = cross3(n, t1);
  const V3 td[4] = {t1, V3{-t1.x, -t1.y, -t1.z}, t2, V3{-t2.x, -t2.y, -t2.z}};
  float bound[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bound[j] = support(s2, bf3(td[j]), false) + dot3(td[j], c2);

  // each side-1 corner's depth below the plane through p2, BIG when it
  // lies laterally outside the hull's footprint
  const V3 mn{-n.x, -n.y, -n.z};
  float cd[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const V3 cw = s1.w[k];
    const V3 rel{cw.x - r.p2.x, cw.y - r.p2.y, cw.z - r.p2.z};
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) ok = ok && (dot3(cw, td[j]) <= bound[j] + kTol);
    cd[k] = s1.ok[k] ? (ok ? dot3(rel, mn) : kBig) : CUDART_INF_F;
  }

  // the 4 deepest corners, ties to the lower corner index
  float dsel[4];
  V3 psel[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float bv = cd[0];
    int bi = lane;
    if (cd[1] < bv) {
      bv = cd[1];
      bi = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int src = bi & 31, hi = bi >> 5;
    const V3 own = hi ? s1.w[1] : s1.w[0];
    psel[q] = V3{__shfl_sync(kFull, own.x, src), __shfl_sync(kFull, own.y, src),
                 __shfl_sync(kFull, own.z, src)};
    dsel[q] = bv;
    if (lane == src) {
      if (hi) {
        cd[1] = CUDART_INF_F;
      } else {
        cd[0] = CUDART_INF_F;
      }
    }
  }

  if (lane == 0) {
    const bool use_fb = dsel[3] >= kBig / 2.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float d = dsel[q];
      V3 pq{psel[q].x - (0.5f * d) * n.x, psel[q].y - (0.5f * d) * n.y,
            psel[q].z - (0.5f * d) * n.z};
      if (q == 3 && use_fb) {
        d = r.dist;
        pq = V3{0.5f * (r.p1.x + r.p2.x), 0.5f * (r.p1.y + r.p2.y), 0.5f * (r.p1.z + r.p2.z)};
      }
      dist4[4 * w + q] = d;
      pos4[12 * w + 3 * q + 0] = pq.x;
      pos4[12 * w + 3 * q + 1] = pq.y;
      pos4[12 * w + 3 * q + 2] = pq.z;
    }
    nrm[3 * w + 0] = n.x;
    nrm[3 * w + 1] = n.y;
    nrm[3 * w + 2] = n.z;
  }
}

int check(int BK, int V1, int V2, int DXp, int DX) {
  if (BK < 0 || V1 < 1 || V2 < 1 || V1 > 64 || V2 > 64 || DX < 0 || DX > DXp) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <bool kWorld>
int launch_pair(const Args& a, float* dist, float* pos, float* n, float* p2, cudaStream_t stream) {
  if (int e = check(a.BK, a.V1, a.V2, a.DXp, a.DX)) return e;
  if (a.BK == 0) return 0;
  const int grid = (a.BK + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hull_pair_kernel<kWorld><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(a, dist, pos, n, p2);
  return (int)cudaGetLastError();
}

template <bool kWorld>
int launch_manifold(const Args& a, float* dist4, float* pos4, float* n, cudaStream_t stream) {
  if (int e = check(a.BK, a.V1, a.V2, a.DXp, a.DX)) return e;
  if (a.V1 < 4) return (int)cudaErrorInvalidValue;
  if (a.BK == 0) return 0;
  const int grid = (a.BK + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hull_manifold_kernel<kWorld><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(a, dist4, pos4, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int robogym_hull_pair(const float* v1l, const float* xm1, const float* xp1,
                                 const float* v2l, const float* xm2, const float* xp2,
                                 const float* c1, const float* c2, const float* xd,
                                 const float* tab, float* dist, float* pos, float* n, float* p2,
                                 int BK, int V1, int V2, int DXp, int DX, cudaStream_t stream) {
  const Args a{v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch_pair<false>(a, dist, pos, n, p2, stream);
}

extern "C" int robogym_hull_pair_world(const float* v1, const float* v2, const float* c1,
                                       const float* c2, const float* xd, const float* tab,
                                       float* dist, float* pos, float* n, float* p2, int BK,
                                       int V1, int V2, int DXp, int DX, cudaStream_t stream) {
  const Args a{v1, nullptr, nullptr, v2, nullptr, nullptr, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch_pair<true>(a, dist, pos, n, p2, stream);
}

extern "C" int robogym_hull_manifold(const float* v1l, const float* xm1, const float* xp1,
                                     const float* v2l, const float* xm2, const float* xp2,
                                     const float* c1, const float* c2, const float* xd,
                                     const float* tab, float* dist4, float* pos4, float* n,
                                     int BK, int V1, int V2, int DXp, int DX,
                                     cudaStream_t stream) {
  const Args a{v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch_manifold<false>(a, dist4, pos4, n, stream);
}

extern "C" int robogym_hull_manifold_world(const float* v1, const float* v2, const float* c1,
                                           const float* c2, const float* xd, const float* tab,
                                           float* dist4, float* pos4, float* n, int BK, int V1,
                                           int V2, int DXp, int DX, cudaStream_t stream) {
  const Args a{v1, nullptr, nullptr, v2, nullptr, nullptr, c1, c2, xd, tab, BK, V1, V2, DXp, DX};
  return launch_manifold<true>(a, dist4, pos4, n, stream);
}
