// The warp-level constraint CG solve that kernels B (cg_full.cu) and F
// (cg.cu) share: M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search, as robogym_tpu/physics/cg_kernel.py
// runs it (the loop body and _line_search_step), for one env in one warp.
//
// Layout (both kernels; cg_full.cu's header comment gives the reasons):
//  - lane = dof: lane i holds dofs i, i + 32, ... (DPL a lane, 1, 2, 4 or
//    8, so V <= 256) of every per-dof vector in registers; M v and M^-1 v
//    take row i in lane i and v_j by shuffle (`Mat`);
//  - lane = rows r = lane (mod 32): jar, J p and the row weights of the
//    first R row slots in registers (`Rows`), the rest spilled (`for_rows`);
//  - reductions are butterfly shuffles that leave the sum in every lane,
//    and lanes exchange data through memory behind __syncwarp: no block
//    barrier anywhere.
// Each kernel hands `cg_solve` a system: its J (J p and J^T f) and its row
// state, with row weights kept as the kernel has them (`KindW`: D, friction
// loss and the row kind packed two bits a row, kernel B; `MaskedW`: D
// premasked by kind, kernel F). The arithmetic of every row and dof
// follows the plain version (`cg_kernel.cg_plain`); only the order of the
// sums differs, and it is fixed, so runs are deterministic.

#pragma once

#include <cuda_runtime.h>

namespace cg_common {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxV = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one block may opt into on Hopper
constexpr int kEq = 0;
constexpr int kOneSided = 1;
constexpr int kFriction = 2;

__host__ __device__ inline int row_stride(int V) { return (V % 2 == 0) ? V + 1 : V; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
}

struct RowW {
  float deq, done, dfr, floss;
};

__device__ __forceinline__ float force_of(float jar, const RowW& w) {
  const float neg = jar < 0.0f ? 1.0f : 0.0f;
  return w.deq * jar + w.done * jar * neg + fminf(fmaxf(w.dfr * jar, -w.floss), w.floss);
}

__device__ __forceinline__ float penalty_of(float jar, const RowW& w) {
  const float neg = jar < 0.0f ? 1.0f : 0.0f;
  const float c_quad = 0.5f * (w.deq + w.done * neg) * jar * jar;
  const float inside = fabsf(w.dfr * jar) < w.floss ? 1.0f : 0.0f;
  const float quad_f = 0.5f * w.dfr * jar * jar;
  const float lin_f = w.floss * fabsf(jar) - 0.5f * w.floss * w.floss / fmaxf(w.dfr, 1e-12f);
  const float c_fric = inside * quad_f + (1.0f - inside) * lin_f;
  return c_quad + c_fric;
}

// A row's weights from its D, friction loss and kind (D masked by kind).
__device__ __forceinline__ RowW weights(float D, float fl, int kd) {
  return RowW{kd == kEq ? D : 0.0f, kd == kOneSided ? D : 0.0f, kd == kFriction ? D : 0.0f, fl};
}

// Copies the (V, V) matrices a and b into rows [0, V) and [V, 2V) of dst
// (row stride Vs), coalesced, 16 loads a lane in flight.
__device__ __forceinline__ void stage_pair(float* dst, const float* a, const float* b, int V,
                                           int Vs) {
  constexpr int kBatch = 8;
  const int n = V * V;
  for (int base = threadIdx.x; base < n; base += 32 * kBatch) {
    float ra[kBatch], rb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 32 * u;
      ra[u] = idx < n ? a[idx] : 0.0f;
      rb[u] = idx < n ? b[idx] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 32 * u;
      if (idx >= n) break;
      const int i = idx / V, j = idx - i * V;
      dst[i * Vs + j] = ra[u];
      dst[(V + i) * Vs + j] = rb[u];
    }
  }
}

template <int DPL>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[DPL], int V) {
#pragma unroll
  for (int q = 0; q < DPL; ++q) {
    const int i = threadIdx.x + 32 * q;
    v[q] = i < V ? src[i] : 0.0f;
  }
}

template <int DPL>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[DPL], int V) {
#pragma unroll
  for (int q = 0; q < DPL; ++q) {
    const int i = threadIdx.x + 32 * q;
    if (i < V) dst[i] = v[q];
  }
}

// out = A v for A in memory (row stride Vs): lane row i = lane + 32 q, v_j
// by shuffle; 0 in the rows past V.
template <int DPL>
__device__ __forceinline__ void smem_matvec(const float* A, const float (&v)[DPL],
                                            float (&out)[DPL], int V, int Vs) {
  const int lane = threadIdx.x;
  float acc[DPL];
  const float* row[DPL];
#pragma unroll
  for (int q = 0; q < DPL; ++q) {
    acc[q] = 0.0f;
    const int i = lane + 32 * q;
    row[q] = A + (i < V ? i : 0) * Vs;
  }
#pragma unroll
  for (int q2 = 0; q2 < DPL; ++q2) {
    if (32 * q2 >= V) break;
    const int n = V - 32 * q2 < 32 ? V - 32 * q2 : 32;
#pragma unroll 2
    for (int j2 = 0; j2 < n; ++j2) {
      const float vj = __shfl_sync(kFull, v[q2], j2);
#pragma unroll
      for (int q = 0; q < DPL; ++q) acc[q] += row[q][32 * q2 + j2] * vj;
    }
  }
#pragma unroll
  for (int q = 0; q < DPL; ++q) out[q] = lane + 32 * q < V ? acc[q] : 0.0f;
}

// A (V, V) matrix that the solve applies: read in place (shared or device
// memory) for V > 32 ...
template <int DPL>
struct Mat {
  const float* a;
  __device__ __forceinline__ void load(const float* staged, int, int) { a = staged; }
  __device__ __forceinline__ void apply(const float (&v)[DPL], float (&out)[DPL], int V,
                                        int Vs) const {
    smem_matvec<DPL>(a, v, out, V, Vs);
  }
};

// ... and for V <= 32 row `lane` in registers, zero past V.
template <>
struct Mat<1> {
  float r[32];
  __device__ __forceinline__ void load(const float* staged, int V, int Vs) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int j = 0; j < 32; ++j) r[j] = (lane < V && j < V) ? staged[lane * Vs + j] : 0.0f;
  }
  __device__ __forceinline__ void apply(const float (&v)[1], float (&out)[1], int V, int) const {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      a0 += r[j] * __shfl_sync(kFull, v[0], j);
      a1 += r[j + 1] * __shfl_sync(kFull, v[0], j + 1);
    }
    out[0] = (int)threadIdx.x < V ? a0 + a1 : 0.0f;
  }
};

// Row weights of the lane's R register row slots: D, friction loss and the
// kind two bits a slot (kernel B) ...
template <int R>
struct KindW {
  float D[R], fl[R];
  int kinds;
  __device__ __forceinline__ RowW get(int k) const {
    return weights(D[k], fl[k], (kinds >> (2 * k)) & 3);
  }
};

// ... or D premasked by kind, as kernel F takes it.
template <int R>
struct MaskedW {
  RowW w[R];
  __device__ __forceinline__ RowW get(int k) const { return w[k]; }
};

// The lane's row slots k (row lane + 32 k): the first R in registers ...
template <int R, class W>
struct Rows {
  float jar[R], Jp[R];
  W w;
};

// ... the others spilled, value k of spilled slot c at [c * 32 + lane] of
// each array: with D, friction loss and kind beside them (kernel B) ...
struct Spill {
  float *jar, *Jp, *D, *fl;
  int* kind;
  __device__ __forceinline__ RowW get(int i, int) const {
    return weights(D[i], fl[i], kind[i]);
  }
};

// ... or with the premasked weights read from the kernel's (E,) inputs, 0
// past E (kernel F).
struct MaskedSpill {
  float *jar, *Jp;
  const float *deq, *done, *dfr, *fl;
  int E;
  __device__ __forceinline__ RowW get(int, int r) const {
    if (r >= E) return RowW{0.0f, 0.0f, 0.0f, 0.0f};
    return RowW{deq[r], done[r], dfr[r], fl[r]};
  }
};

// fn(k, jar, Jp, w) on each of the lane's row slots, jar and Jp writable.
template <int R, class W, class S, class Fn>
__device__ __forceinline__ void for_rows(Rows<R, W>& rs, const S& sp, int nk, Fn&& fn) {
#pragma unroll
  for (int k = 0; k < R; ++k) fn(k, rs.jar[k], rs.Jp[k], rs.w.get(k));
  for (int k = R; k < nk; ++k) {
    const int i = (k - R) * 32 + threadIdx.x;
    float jar = sp.jar[i], jp = sp.Jp[i];
    fn(k, jar, jp, sp.get(i, threadIdx.x + 32 * k));
    sp.jar[i] = jar;
    sp.Jp[i] = jp;
  }
}

// out = J v on the lane's row slots, J in shared memory by column (stride
// CS), v_j by shuffle, each column's value used for every register row.
template <int DPL, int R>
__device__ __forceinline__ void j_times(const float* J, int CS, int V, int nk,
                                        const float (&v)[DPL], float (&out)[R], float* spill) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int k = 0; k < R; ++k) out[k] = 0.0f;
  const float* col = J + lane;
#pragma unroll
  for (int q2 = 0; q2 < DPL; ++q2) {
    if (32 * q2 >= V) break;
    const int n = V - 32 * q2 < 32 ? V - 32 * q2 : 32;
#pragma unroll 2
    for (int j2 = 0; j2 < n; ++j2) {
      const float vj = __shfl_sync(kFull, v[q2], j2);
#pragma unroll
      for (int k = 0; k < R; ++k) out[k] += col[32 * k] * vj;
      col += CS;
    }
  }
  for (int k = R; k < nk; ++k) {
    const float* c = J + lane + 32 * k;
    float s = 0.0f;
#pragma unroll
    for (int q2 = 0; q2 < DPL; ++q2) {
      if (32 * q2 >= V) break;
      const int n = V - 32 * q2 < 32 ? V - 32 * q2 : 32;
      for (int j2 = 0; j2 < n; ++j2) s += c[(32 * q2 + j2) * CS] * __shfl_sync(kFull, v[q2], j2);
    }
    spill[(k - R) * 32 + lane] = s;
  }
}

// out = J^T f for the lane's dofs; J(r, c) = col[c][r * rs] (J by column in
// shared memory: col = J + c CS, rs = 1; J by row in device memory: col =
// J + c, rs = V), f (E,) 16-byte aligned. A fixed order: eight partial sums
// over the rows (r mod 8) for the whole blocks of eight, folded into four,
// then a block of four and the last rows; 0 past V.
template <int DPL>
__device__ __forceinline__ void jt_times(const float* J, const float* f, int E, int V, int cstride,
                                         int rstride, float (&out)[DPL]) {
  const int lane = threadIdx.x;
  const float* col[DPL];
  float a[DPL][4], b[DPL][4];  // rows r mod 8 < 4, and the other four
#pragma unroll
  for (int q = 0; q < DPL; ++q) {
    const int c = lane + 32 * q;
    col[q] = J + (c < V ? c : 0) * cstride;
#pragma unroll
    for (int u = 0; u < 4; ++u) a[q][u] = b[q][u] = 0.0f;
  }
  int r = 0;
  for (; r + 8 <= E; r += 8) {
    const float4 f0 = *reinterpret_cast<const float4*>(f + r);
    const float4 f1 = *reinterpret_cast<const float4*>(f + r + 4);
    const float fa[4] = {f0.x, f0.y, f0.z, f0.w}, fb[4] = {f1.x, f1.y, f1.z, f1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < DPL; ++q) {
        a[q][u] += col[q][(r + u) * rstride] * fa[u];
        b[q][u] += col[q][(r + 4 + u) * rstride] * fb[u];
      }
  }
#pragma unroll
  for (int q = 0; q < DPL; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) a[q][u] = a[q][u] + b[q][u];
  if (r + 4 <= E) {
    const float4 f0 = *reinterpret_cast<const float4*>(f + r);
    const float fa[4] = {f0.x, f0.y, f0.z, f0.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < DPL; ++q) a[q][u] += col[q][(r + u) * rstride] * fa[u];
    r += 4;
  }
  for (; r < E; ++r) {
#pragma unroll
    for (int q = 0; q < DPL; ++q) a[q][0] += col[q][r * rstride] * f[r];
  }
#pragma unroll
  for (int q = 0; q < DPL; ++q)
    out[q] = lane + 32 * q < V ? (a[q][0] + a[q][1]) + (a[q][2] + a[q][3]) : 0.0f;
}

// An env's system with J in shared memory by column (stride CS = 32 n + 1,
// n >= the row slots): J p with lane = row, J^T f with lane = dof, the row
// forces fs in shared memory; row weights W in registers, S past them.
template <int DPL, int R, class W, class S>
struct ColSys {
  const float* J;
  int CS, V, E, nk;
  float* fs;
  Rows<R, W> rs;
  S sp;
  template <class Fn>
  __device__ __forceinline__ void rows(Fn&& fn) {
    for_rows(rs, sp, nk, fn);
  }
  __device__ __forceinline__ void jp(const float (&v)[DPL]) {
    j_times<DPL, R>(J, CS, V, nk, v, rs.Jp, sp.Jp);
  }
  __device__ __forceinline__ void jtf(float (&out)[DPL]) {
    jt_times<DPL>(J, fs, E, V, CS, 1, out);
  }
};

// Floats of one slot of a CG solve's trace for V dofs and E rows: x (V),
// jar (E), the search direction pd, g and M^-1 g (V each), the line
// search's pick and beta.
__host__ __device__ inline int trace_floats(int V, int E) { return 4 * V + E + 2; }

// Writes the state that the next CG iteration reads into one slot of an
// env's trace (`trace_floats`): x, jar, pd, g, Mg, the pick (0 to 3 for
// the step a1 x {2, 1, 0.5, 0.125}, 4 for no step, -1 for the set-up) and
// beta.
template <int DPL, class Sys>
__device__ __forceinline__ void trace_state(float* tr, Sys& sys, const float (&x)[DPL],
                                            const float (&pd)[DPL], const float (&g)[DPL],
                                            const float (&Mg)[DPL], int pick, float beta, int V) {
  const int E = sys.E;
  store_vec(tr, x, V);
  sys.rows([&](int k, float& j, float&, const RowW&) {
    const int r = threadIdx.x + 32 * k;
    if (r < E) tr[V + r] = j;
  });
  store_vec(tr + V + E, pd, V);
  store_vec(tr + 2 * V + E, g, V);
  store_vec(tr + 3 * V + E, Mg, V);
  if (threadIdx.x == 0) {
    tr[4 * V + E] = (float)pick;
    tr[4 * V + E + 1] = beta;
  }
}

// The CG solve of one env. `sys` holds the env's J and row state: sys.jp(v)
// sets its J p to J v, sys.jtf(out) sets out = J^T sys.fs, sys.rows(fn)
// calls fn(k, jar, Jp, w) on each of the lane's row slots (`for_rows`), and
// sys.fs (E,) is the row forces that J^T f reads. From x (the warmstart)
// and jar = J x - aref, it leaves the solution in x and jar, and f =
// -force(jar) in sys.fs and f_out (the env's E rows). M and Minv have row
// stride Vs. A non-null `trace` (the env's iterations + 1 slots of
// `trace_floats`) gets the state after the set-up in slot 0 and after
// iteration it in slot it + 1 (`trace_state`); null leaves the arithmetic
// as it is.
template <int DPL, class Sys, class MatT>
__device__ __forceinline__ void cg_solve(Sys& sys, const MatT& M, const MatT& Minv,
                                         float (&x)[DPL], const float (&qs)[DPL], float* f_out,
                                         int V, int Vs, int iterations, float* trace) {
  const int lane = threadIdx.x, E = sys.E;
  const int T = trace_floats(V, E);
  float* fs = sys.fs;

  // g = M (x - qs) + J^T force(jar); Mg = M^-1 g; p = -Mg
  float pd[DPL], g[DPL], Mg[DPL], gn[DPL], Mgn[DPL], Mp[DPL], dx[DPL], t[DPL];
  sys.rows([&](int k, float& j, float&, const RowW& w) {
    const int r = lane + 32 * k;
    if (r < E) fs[r] = force_of(j, w);
  });
#pragma unroll
  for (int q = 0; q < DPL; ++q) dx[q] = x[q] - qs[q];
  __syncwarp();
  sys.jtf(gn);
  M.apply(dx, t, V, Vs);
#pragma unroll
  for (int q = 0; q < DPL; ++q) g[q] = t[q] + gn[q];
  Minv.apply(g, Mg, V, Vs);
#pragma unroll
  for (int q = 0; q < DPL; ++q) pd[q] = -Mg[q];
  if (trace) trace_state(trace, sys, x, pd, g, Mg, -1, 0.0f, V);

  const float scales[4] = {2.0f, 1.0f, 0.5f, 0.125f};
  for (int it = 0; it < iterations; ++it) {
    sys.jp(pd);
    M.apply(pd, Mp, V, Vs);

    // c1, c2, f0.Jp, deff.Jp.Jp, penalty at a = 0
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      acc[0] += (x[q] - qs[q]) * Mp[q];
      acc[1] += pd[q] * Mp[q];
    }
    sys.rows([&](int, float& j, float& jp, const RowW& w) {
      const float neg = j < 0.0f ? 1.0f : 0.0f;
      const float inside = fabsf(w.dfr * j) < w.floss ? 1.0f : 0.0f;
      const float deff = (w.deq + w.done * neg) + w.dfr * inside;
      acc[2] += force_of(j, w) * jp;
      acc[3] += deff * jp * jp;
      acc[4] += penalty_of(j, w);
    });
    warp_sums(acc);
    const float c1 = acc[0], c2 = acc[1];
    const float phi_p = c1 + acc[2];
    const float phi_pp = fmaxf(c2 + acc[3], 1e-12f);
    const float a1 = fminf(fmaxf(-phi_p / phi_pp, 0.0f), 2.0f);
    const float pen0 = acc[4];

    float pen[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    sys.rows([&](int, float& j, float& jp, const RowW& w) {
#pragma unroll
      for (int k = 0; k < 4; ++k) pen[k] += penalty_of(j + (a1 * scales[k]) * jp, w);
    });
    warp_sums(pen);
    float best_cost = 0.0f, best_a = 0.0f;
    int best_k = 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = a1 * scales[k];
      const float dcost = a * c1 + 0.5f * a * a * c2 + pen[k] - pen0;
      if (dcost < best_cost) {
        best_cost = dcost;
        best_a = a;
        best_k = k;
      }
    }

#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      x[q] = x[q] + best_a * pd[q];
      dx[q] = x[q] - qs[q];
    }
    __syncwarp();
    sys.rows([&](int k, float& j, float& jp, const RowW& w) {
      j = j + best_a * jp;
      const int r = lane + 32 * k;
      if (r < E) fs[r] = force_of(j, w);
    });
    __syncwarp();
    sys.jtf(Mgn);
    M.apply(dx, t, V, Vs);
#pragma unroll
    for (int q = 0; q < DPL; ++q) gn[q] = t[q] + Mgn[q];
    Minv.apply(gn, Mgn, V, Vs);
    float nd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      nd[0] += gn[q] * (Mgn[q] - Mg[q]);
      nd[1] += g[q] * Mg[q];
    }
    warp_sums(nd);
    const float beta = fmaxf(nd[0] / fmaxf(nd[1], 1e-12f), 0.0f);
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      pd[q] = -Mgn[q] + beta * pd[q];
      g[q] = gn[q];
      Mg[q] = Mgn[q];
    }
    if (trace) trace_state(trace + (size_t)(it + 1) * T, sys, x, pd, g, Mg, best_k, beta, V);
  }

  // f = -force(jar)
  __syncwarp();
  sys.rows([&](int k, float& j, float&, const RowW& w) {
    const int r = lane + 32 * k;
    if (r >= E) return;
    const float fv = -force_of(j, w);
    fs[r] = fv;
    f_out[r] = fv;
  });
}

}  // namespace cg_common
