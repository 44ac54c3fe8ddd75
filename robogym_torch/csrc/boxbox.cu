// Box-box contact manifold for Hopper (sm_90a): SAT over the 15 axes (the 3
// face normals of each box and their 9 cross products) picks the normal;
// the 17 candidates are the 8 corners of box 2 inside box 1, the 8 corners
// of box 1 inside box 2 (within 1e-3), and the SAT witness point.
//
// Replaces robogym_tpu/physics/collision/boxbox_kernel.py:_boxbox_kernel.
//
// Bound on this card: per pair the kernel reads 30 floats and writes 71
// (17 distances, 17 positions, one normal), and does about 2,000 flops, so
// at B=1024 and 15 pairs the bytes bound it (6.2 MB, about 2 microseconds).
// One thread a pair (the design this one replaced) left the card under one
// warp a scheduler at that size, with each thread's serial chain of 15 SAT
// depths, 16 corners and the witness, and loads and stores strided by a
// pair's 30 and 71 floats.
//
// Design: a group of kGroup = 8 lanes a pair, 4 pairs a warp, each warp on
// its own (no block barrier); on an H100 at B=1024, K=15 a group of 16 took
// 1.28 times as long, and 2 or 8 warps a block as long as 4 (PERF.md).
// - Staged loads: a warp's pairs are contiguous in every operand, so its
//   lanes load each operand's range (pairs x 3 or 9 floats) with
//   consecutive lanes on consecutive floats, all loads in flight before the
//   first is staged in the warp's shared tile; a lane reads the boxes from
//   there.
// - SAT across lanes: lane l owns axes l and l + 8 of the plain version's
//   order (0-2 box 1's axes, 3-5 box 2's, 6 + 3i + j cross(box 1's i, box
//   2's j); index 15 is no axis) and computes each depth as the plain
//   version does. One argmin over the group on (key, axis index) in 3
//   xor-shuffle rounds, ties to the lower index, then the winner's axis and
//   depth from its lane by shuffles; every lane normalises and orients the
//   normal with the same bits.
// - Candidates across lanes: lane l makes candidates l (box 2's corner l
//   against box 1, sign +1) and 8 + l (box 1's corner l against box 2, sign
//   -1); the witness's two supports are lanes 6 and 7's (box 1's along n,
//   box 2's along -n), joined by one shuffle.
// - Staged stores: the outputs are pair-major, so a warp's dist, pos and
//   normal are contiguous; each lane writes its candidates into the warp's
//   shared tile, and the warp stores the three ranges with consecutive
//   lanes on consecutive floats.
// A group past the last pair computes the last pair again, so that every
// lane takes part in every shuffle, and writes nothing.
//
// The arithmetic is the plain version's (boxbox_kernel.boxbox_plain),
// operation for operation in the same order, with IEEE 1.0f / sqrtf for
// its 1 / torch.sqrt; built with -fmad=false, every depth, corner and
// witness rounds as the plain version's do, and the argmin picks the axis
// of its strict running minimum (see `sat_key`).

#include <math_constants.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;                        // lanes a pair (8 or 16)
constexpr int kPairsPerWarp = 32 / kGroup;
constexpr int kWarps = 4;                        // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPairsPerBlock = kPairsPerWarp * kWarps;
constexpr int kAxes = 15;
constexpr int kCand = 17;
constexpr int kSlots = 16 / kGroup;              // axes and corners a lane
constexpr float kBig = 1e10f;
static_assert(kGroup == 8 || kGroup == 16, "a group holds 8 or 16 lanes");

// A warp's shared tile, in floats: the input, operand after operand (xp1,
// xm1, s1, xp2, xm2, s2, each kPairsPerWarp pairs wide), then the output
// (dist, pos, normal).
constexpr int kBoxFloats = 15 * kPairsPerWarp;   // one box of every pair
constexpr int kInFloats = 2 * kBoxFloats;
constexpr int kOutDist = kInFloats;
constexpr int kOutPos = kOutDist + kCand * kPairsPerWarp;
constexpr int kOutNormal = kOutPos + 3 * kCand * kPairsPerWarp;
constexpr int kWarpFloats = kOutNormal + 3 * kPairsPerWarp;

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

// box j (0 or 1) of the warp's pair pb, from the staged tile: its centre,
// rotation and half-sizes lie at 3 pb, 3 kPairsPerWarp + 9 pb and
// 12 kPairsPerWarp + 3 pb of the box's part
__device__ __forceinline__ const float* box_xp(const float* tile, int j, int pb) {
  return tile + j * kBoxFloats + 3 * pb;
}
__device__ __forceinline__ const float* box_xm(const float* tile, int j, int pb) {
  return tile + j * kBoxFloats + 3 * kPairsPerWarp + 9 * pb;
}
__device__ __forceinline__ const float* box_s(const float* tile, int j, int pb) {
  return tile + j * kBoxFloats + 12 * kPairsPerWarp + 3 * pb;
}

// column i of a row-major rotation
__device__ __forceinline__ V3 column(const float* xm, int i) { return V3{xm[i], xm[3 + i], xm[6 + i]}; }

__device__ __forceinline__ Box box_at(const float* tile, int j, int pb) {
  const float* xp = box_xp(tile, j, pb);
  const float* xm = box_xm(tile, j, pb);
  const float* s = box_s(tile, j, pb);
  Box b;
  b.p = V3{xp[0], xp[1], xp[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) b.a[i] = column(xm, i);
#pragma unroll
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

// The argmin's key of axis k's depth d. The plain version keeps a strict
// running minimum in axis order: a NaN at axis 0 stays (no comparison with
// it is true), a NaN at a later axis is never taken, and the first of
// exactly tied depths wins. A tree argmin on (key, index), ties to the
// lower index, picks the same axis when a NaN at axis 0 is -inf and a NaN
// elsewhere +inf: axis 0's key then beats every +inf key (the index
// decides), so a NaN past axis 0 and the group's empty index (+inf, 15)
// never win, while a finite depth, kBig among them, beats them both.
__device__ __forceinline__ float sat_key(float d, int k) {
  return d != d ? (k == 0 ? -CUDART_INF_F : CUDART_INF_F) : d;
}

__device__ __forceinline__ bool before(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

__device__ __forceinline__ float dsign(float x) {
  return fabsf(x) > 1e-6f ? (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)) : 0.0f;
}

// floats [0, n) of a warp's staged range of at most N floats to dst, lane
// after lane
template <int N>
__device__ __forceinline__ void store_range(float* dst, const float* src, int n, int lane) {
#pragma unroll
  for (int r = 0; r < (N + 31) / 32; ++r) {
    const int i = lane + 32 * r;
    if (i < n) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads) boxbox_kernel(
    const float* __restrict__ xp1, const float* __restrict__ xm1, const float* __restrict__ s1,
    const float* __restrict__ xp2, const float* __restrict__ xm2, const float* __restrict__ s2,
    float* __restrict__ dist, float* __restrict__ pos, float* __restrict__ normal, int n_pairs) {
  __shared__ float tiles[kWarps][kWarpFloats];
  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * kPairsPerWarp;   // the warp's first pair
  if (q0 >= n_pairs) return;
  const int live = n_pairs - q0 < kPairsPerWarp ? n_pairs - q0 : kPairsPerWarp;  // its pairs
  float* tile = tiles[warp];

  // staged loads: a lane's floats of the six operands, all in flight
  // before the first is staged
  const float* const ops[6] = {xp1, xm1, s1, xp2, xm2, s2};
  constexpr int kWidth[6] = {3, 9, 3, 3, 9, 3};
  constexpr int kLoads = (9 * kPairsPerWarp + 31) / 32;   // a lane's floats of an operand
  float v[6][kLoads];
#pragma unroll
  for (int o = 0; o < 6; ++o) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int i = lane32 + 32 * r;
      v[o][r] = i < live * kWidth[o] ? ops[o][(size_t)q0 * kWidth[o] + i] : 0.0f;
    }
  }
  int at = 0;
#pragma unroll
  for (int o = 0; o < 6; ++o) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int i = lane32 + 32 * r;
      if (i < kWidth[o] * kPairsPerWarp) tile[at + i] = v[o][r];
    }
    at += kWidth[o] * kPairsPerWarp;
  }
  __syncwarp();

  const int lane = lane32 % kGroup;
  const int pb = lane32 / kGroup < live ? lane32 / kGroup : live - 1;  // the group's pair
  const Box b1 = box_at(tile, 0, pb), b2 = box_at(tile, 1, pb);
  const V3 t{b2.p.x - b1.p.x, b2.p.y - b1.p.y, b2.p.z - b1.p.z};

  // SAT: this lane's axes, then the group's argmin
  float key = CUDART_INF_F, depth = 0.0f;
  int k_best = kAxes;
  V3 ax_best{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int k = lane + kGroup * r;
    if (k >= kAxes) break;
    V3 ax;
    float nrm2 = 1.0f;   // a box axis is taken as it is
    if (k < 6) {
      ax = column(box_xm(tile, k / 3, pb), k % 3);
    } else {
      const V3 cx = cross(column(box_xm(tile, 0, pb), (k - 6) / 3),
                          column(box_xm(tile, 1, pb), (k - 6) % 3));
      nrm2 = dot(cx, cx);
      const float inv = 1.0f / sqrtf(nrm2 + 1e-18f);
      ax = V3{cx.x * inv, cx.y * inv, cx.z * inv};
    }
    const float d = nrm2 > 1e-12f ? depth_of(ax, b1, b2, t) : kBig;
    const float kk = sat_key(d, k);
    if (before(kk, k, key, k_best)) {
      key = kk;
      k_best = k;
      depth = d;
      ax_best = ax;
    }
  }
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, key, o);
    const int oi = __shfl_xor_sync(kFull, k_best, o);
    if (before(ov, oi, key, k_best)) {
      key = ov;
      k_best = oi;
    }
  }
  const int src = lane32 - lane + k_best % kGroup;
  const float best = __shfl_sync(kFull, depth, src);
  const V3 bn{__shfl_sync(kFull, ax_best.x, src), __shfl_sync(kFull, ax_best.y, src),
              __shfl_sync(kFull, ax_best.z, src)};

  // unit-normalize and orient from box 1 to box 2
  const float inv = 1.0f / sqrtf(bn.x * bn.x + bn.y * bn.y + bn.z * bn.z + 1e-24f);
  V3 n{bn.x * inv, bn.y * inv, bn.z * inv};
  const float flip = dot(n, t) < 0.0f ? -1.0f : 1.0f;
  n = V3{n.x * flip, n.y * flip, n.z * flip};

  float* out_d = tile + kOutDist + kCand * pb;
  float* out_p = tile + kOutPos + 3 * kCand * pb;
  const bool writes = lane32 / kGroup < live;

  // corner candidates: c < 8 box 2's corner c against box 1, c >= 8 box
  // 1's corner c - 8 against box 2
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int c = lane + kGroup * r, side = c / 8;
    const Box a = side ? b2 : b1, b = side ? b1 : b2;
    const float sign = side ? -1.0f : 1.0f;
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
    if (writes) {
      out_d[c] = d;
#pragma unroll
      for (int i = 0; i < 3; ++i) out_p[3 * c + i] = corner[i] - 0.5f * d * sign * comp(n, i);
    }
  }

  // SAT witness: the midpoint of box 1's support along n and box 2's along
  // -n, signs dead-banded; even lanes take box 1's and odd lanes box 2's,
  // and lane kGroup - 2 joins its own with lane kGroup - 1's
  {
    const int j = lane & 1;
    const Box b = j ? b2 : b1;
    const V3 dir = j ? V3{-n.x, -n.y, -n.z} : n;
    float w[3], sup[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = dsign(dot(b.a[k], dir)) * b.s[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sup[i] = comp(b.p, i) + ((w[0] * comp(b.a[0], i) + w[1] * comp(b.a[1], i)) +
                               w[2] * comp(b.a[2], i));
    }
    const float sup2[3] = {__shfl_xor_sync(kFull, sup[0], 1), __shfl_xor_sync(kFull, sup[1], 1),
                           __shfl_xor_sync(kFull, sup[2], 1)};
    if (writes && lane == kGroup - 2) {
      out_d[kCand - 1] = -best;
#pragma unroll
      for (int i = 0; i < 3; ++i) out_p[3 * (kCand - 1) + i] = 0.5f * (sup[i] + sup2[i]);
    }
  }
  if (writes && lane < 3) tile[kOutNormal + 3 * pb + lane] = comp(n, lane);
  __syncwarp();

  // staged stores: the warp's live pairs, consecutive lanes on consecutive floats
  const size_t first = q0;
  store_range<kCand * kPairsPerWarp>(dist + first * kCand, tile + kOutDist, live * kCand, lane32);
  store_range<3 * kCand * kPairsPerWarp>(pos + first * kCand * 3, tile + kOutPos,
                                         live * kCand * 3, lane32);
  store_range<3 * kPairsPerWarp>(normal + first * 3, tile + kOutNormal, live * 3, lane32);
}

}  // namespace

extern "C" int robogym_boxbox(const float* xp1, const float* xm1, const float* s1,
                              const float* xp2, const float* xm2, const float* s2, float* dist,
                              float* pos, float* normal, int n_pairs, cudaStream_t stream) {
  if (n_pairs < 0) return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return (int)cudaSuccess;
  const int blocks = (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  boxbox_kernel<<<blocks, kThreads, 0, stream>>>(xp1, xm1, s1, xp2, xm2, s2, dist, pos, normal,
                                                 n_pairs);
  return (int)cudaGetLastError();
}

// The kernel's layout into out: lanes a pair, pairs a block, threads a
// block, shared memory a block (bytes), registers a thread, blocks an SM
// by the occupancy calculator. Returns a CUDA error.
extern "C" int robogym_boxbox_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, boxbox_kernel);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, boxbox_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = kGroup;
  out[1] = kPairsPerBlock;
  out[2] = kThreads;
  out[3] = (int)sizeof(float) * kWarps * kWarpFloats;
  out[4] = attr.numRegs;
  out[5] = blocks;
  return 0;
}
