// Box-box contact manifold for Hopper (sm_90a): SAT over the 15 axes (the 3
// face normals of each box and their 9 cross products) picks the normal;
// the 17 candidates are the 8 corners of box 2 inside box 1, the 8 corners
// of box 1 inside box 2 (within 1e-3), and the SAT witness point.
//
// Replaces robogym_tpu/physics/collision/boxbox_kernel.py:_boxbox_kernel.
//
// Bound on this card: per pair the kernel reads 30 floats and writes 71
// (17 distances, 17 positions, one normal), and does about 1,300 flops, so
// at B=1024 and 15 pairs the bytes bound it (6.2 MB, about 2 microseconds).
//
// Design: one thread per (env, pair); the 15 axes and 17 candidates are
// held in registers and the outputs written batch-major. The arithmetic is
// the plain version's (boxbox_kernel.boxbox_plain), operation for operation
// in the same order, with IEEE 1.0f / sqrtf for its 1 / torch.sqrt; built
// with -fmad=false, the SAT depths round as the plain version's do, so its
// strict running minimum (the first of exactly tied axes wins) picks the
// same axis.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCand = 17;
constexpr float kBig = 1e10f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(const V3& u, const V3& v) {
  return u.x * v.x + u.y * v.y + u.z * v.z;
}

__device__ __forceinline__ V3 cross(const V3& u, const V3& v) {
  return V3{u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x};
}

__device__ __forceinline__ float comp(const V3& v, int i) { return i == 0 ? v.x : (i == 1 ? v.y : v.z); }

struct Box {
  V3 p;       // centre
  V3 a[3];    // world axes: the columns of the row-major rotation
  float s[3]; // half-sizes
};

__device__ __forceinline__ Box load_box(const float* xp, const float* xm, const float* s) {
  Box b;
  b.p = V3{xp[0], xp[1], xp[2]};
  for (int i = 0; i < 3; ++i) b.a[i] = V3{xm[i], xm[3 + i], xm[6 + i]};
  for (int i = 0; i < 3; ++i) b.s[i] = s[i];
  return b;
}

__device__ __forceinline__ float depth_of(const V3& ax, const Box& b1, const Box& b2, const V3& t) {
  const float p1 = fabsf(dot(ax, b1.a[0])) * b1.s[0] + fabsf(dot(ax, b1.a[1])) * b1.s[1] +
                   fabsf(dot(ax, b1.a[2])) * b1.s[2];
  const float p2 = fabsf(dot(ax, b2.a[0])) * b2.s[0] + fabsf(dot(ax, b2.a[1])) * b2.s[1] +
                   fabsf(dot(ax, b2.a[2])) * b2.s[2];
  return p1 + p2 - fabsf(dot(ax, t));
}

__device__ __forceinline__ float dsign(float x) {
  return fabsf(x) > 1e-6f ? (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)) : 0.0f;
}

// Corners of box b against box a, written to candidates [k0, k0 + 8).
__device__ __forceinline__ void corner_candidates(const Box& a, const Box& b, float sign,
                                                  const V3& n, float* dist, float* pos, int k0) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float sg[3] = {(c & 4) ? 1.0f : -1.0f, (c & 2) ? 1.0f : -1.0f, (c & 1) ? 1.0f : -1.0f};
    float corner[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      corner[i] = comp(b.p, i) + ((sg[0] * b.s[0] * comp(b.a[0], i) +
                                   sg[1] * b.s[1] * comp(b.a[1], i)) +
                                  sg[2] * b.s[2] * comp(b.a[2], i));
    }
    const V3 rel{corner[0] - a.p.x, corner[1] - a.p.y, corner[2] - a.p.z};
    const float o0 = fabsf(dot(rel, a.a[0])) - a.s[0];
    const float o1 = fabsf(dot(rel, a.a[1])) - a.s[1];
    const float o2 = fabsf(dot(rel, a.a[2])) - a.s[2];
    const bool inside = (o0 < 1e-3f) && (o1 < 1e-3f) && (o2 < 1e-3f);
    const float d = inside ? fmaxf(fmaxf(o0, o1), o2) : kBig;
    dist[k0 + c] = d;
#pragma unroll
    for (int i = 0; i < 3; ++i) pos[(k0 + c) * 3 + i] = corner[i] - 0.5f * d * sign * comp(n, i);
  }
}

__global__ void __launch_bounds__(kThreads) boxbox_kernel(
    const float* __restrict__ xp1, const float* __restrict__ xm1, const float* __restrict__ s1,
    const float* __restrict__ xp2, const float* __restrict__ xm2, const float* __restrict__ s2,
    float* __restrict__ dist, float* __restrict__ pos, float* __restrict__ normal, int n_pairs) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n_pairs) return;
  const Box b1 = load_box(xp1 + 3 * q, xm1 + 9 * q, s1 + 3 * q);
  const Box b2 = load_box(xp2 + 3 * q, xm2 + 9 * q, s2 + 3 * q);
  const V3 t{b2.p.x - b1.p.x, b2.p.y - b1.p.y, b2.p.z - b1.p.z};

  // SAT: a running strict minimum in axis order keeps the first tied axis
  float best = depth_of(b1.a[0], b1, b2, t);
  V3 bn = b1.a[0];
  for (int k = 1; k < 6; ++k) {
    const V3 ax = k < 3 ? b1.a[k] : b2.a[k - 3];
    const float d = depth_of(ax, b1, b2, t);
    if (d < best) {
      best = d;
      bn = ax;
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const V3 cx = cross(b1.a[i], b2.a[j]);
      const float nrm2 = dot(cx, cx);
      const float inv = 1.0f / sqrtf(nrm2 + 1e-18f);
      const V3 ax{cx.x * inv, cx.y * inv, cx.z * inv};
      const float d = nrm2 > 1e-12f ? depth_of(ax, b1, b2, t) : kBig;
      if (d < best) {
        best = d;
        bn = ax;
      }
    }
  }
  // unit-normalize and orient from box 1 to box 2
  const float inv = 1.0f / sqrtf(bn.x * bn.x + bn.y * bn.y + bn.z * bn.z + 1e-24f);
  V3 n{bn.x * inv, bn.y * inv, bn.z * inv};
  const float flip = dot(n, t) < 0.0f ? -1.0f : 1.0f;
  n = V3{n.x * flip, n.y * flip, n.z * flip};

  float d[kCand], p[kCand * 3];
  corner_candidates(b1, b2, 1.0f, n, d, p, 0);
  corner_candidates(b2, b1, -1.0f, n, d, p, 8);

  // SAT witness: the midpoint of the two supports (dead-banded signs)
  const V3 nneg{-n.x, -n.y, -n.z};
  float w1[3], w2[3];
  for (int k = 0; k < 3; ++k) {
    w1[k] = dsign(dot(b1.a[k], n)) * b1.s[k];
    w2[k] = dsign(dot(b2.a[k], nneg)) * b2.s[k];
  }
  d[16] = -best;
  for (int i = 0; i < 3; ++i) {
    const float sup1 = comp(b1.p, i) + ((w1[0] * comp(b1.a[0], i) + w1[1] * comp(b1.a[1], i)) +
                                        w1[2] * comp(b1.a[2], i));
    const float sup2 = comp(b2.p, i) + ((w2[0] * comp(b2.a[0], i) + w2[1] * comp(b2.a[1], i)) +
                                        w2[2] * comp(b2.a[2], i));
    p[16 * 3 + i] = 0.5f * (sup1 + sup2);
  }

  float* dq = dist + (size_t)q * kCand;
  float* pq = pos + (size_t)q * kCand * 3;
#pragma unroll
  for (int k = 0; k < kCand; ++k) dq[k] = d[k];
#pragma unroll
  for (int k = 0; k < kCand * 3; ++k) pq[k] = p[k];
  normal[3 * q + 0] = n.x;
  normal[3 * q + 1] = n.y;
  normal[3 * q + 2] = n.z;
}

}  // namespace

extern "C" int robogym_boxbox(const float* xp1, const float* xm1, const float* s1,
                              const float* xp2, const float* xm2, const float* s2, float* dist,
                              float* pos, float* normal, int n_pairs, cudaStream_t stream) {
  if (n_pairs < 0) return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return (int)cudaSuccess;
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  boxbox_kernel<<<blocks, kThreads, 0, stream>>>(xp1, xm1, s1, xp2, xm2, s2, dist, pos, normal,
                                                 n_pairs);
  return (int)cudaGetLastError();
}
