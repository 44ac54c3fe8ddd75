// The constraint CG solve of kernel F (cg.cu): M^-1-preconditioned
// Polak-Ribiere+ nonlinear CG with the frozen-active-set Newton line
// search, as robogym_tpu/physics/cg_kernel.py runs it in _cg_kernel (the
// loop body and _line_search_step). Kernel B (cg_full.cu, one warp per env)
// has its own loop and takes only the row arithmetic (force_of,
// penalty_of), warp_sum and row_stride from here.
//
// One thread block per env. The caller puts J (E x V, odd row stride Vs), M
// and M^-1 (V x Vs) and the per-row weights in shared memory, sets x to the
// warmstart and jar = J x - aref, and calls cg_iterate; x and jar then hold
// the solution. J x and M x take a thread per row; J^T f splits the rows
// over thread groups and sums the partials; the dot products and the five
// line-search costs are block reductions that every thread reads back, so
// the line search and the Polak-Ribiere step run uniformly in every thread.
// The order of the arithmetic inside each row and dof follows the plain
// version; only the order of the sums differs.

#pragma once

#include <cuda_runtime.h>

namespace cg_common {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 64;             // floats of reduction scratch
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one block may opt into on Hopper

__host__ __device__ inline int row_stride(int V) { return (V % 2 == 0) ? V + 1 : V; }

// Floats of shared memory for E rows, V dofs and nmat (V, V) matrices.
__host__ inline size_t smem_floats(int E, int V, int nmat) {
  const int Vs = row_stride(V);
  return (size_t)E * Vs + (size_t)nmat * V * Vs + 7 * (size_t)E + 10 * (size_t)V + kThreads +
         kRed;
}

// Shared memory of one block: J, the matrices, per-row and per-dof vectors.
struct Smem {
  float* J;       // (E, Vs)
  float* mat;     // nmat x (V, Vs): M, M^-1, then the caller's own
  float *deq, *done, *dfr, *fl;  // per row: D masked by kind, friction loss
  float *jar, *Jp, *fr;          // per row: J x - aref, J p, force
  float *x, *qs, *pd, *g, *Mg, *gn, *Mgn, *Mp, *dx, *qv;  // per dof
  float *partial, *red;
};

__device__ inline Smem carve(float* sm, int E, int V, int nmat) {
  const int Vs = row_stride(V);
  Smem s;
  s.J = sm;
  s.mat = s.J + (size_t)E * Vs;
  float* r = s.mat + (size_t)nmat * V * Vs;
  float** rows[7] = {&s.deq, &s.done, &s.dfr, &s.fl, &s.jar, &s.Jp, &s.fr};
  for (int k = 0; k < 7; ++k) *rows[k] = r + k * E;
  float* d = r + 7 * E;
  float** dofs[10] = {&s.x, &s.qs, &s.pd, &s.g, &s.Mg, &s.gn, &s.Mgn, &s.Mp, &s.dx, &s.qv};
  for (int k = 0; k < 10; ++k) *dofs[k] = d + k * V;
  s.partial = d + 10 * V;
  s.red = s.partial + kThreads;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums N values over the block; every thread gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[k * kWarps + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
    v[k] = s;
  }
  __syncthreads();
}

struct RowW {
  float deq, done, dfr, floss;
};

__device__ __forceinline__ RowW row_w(const Smem& s, int r) {
  return RowW{s.deq[r], s.done[r], s.dfr[r], s.fl[r]};
}

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

__device__ __forceinline__ float dotn(const float* a, const float* x, int n) {
  float s = 0.0f;
  for (int j = 0; j < n; ++j) s += a[j] * x[j];
  return s;
}

// out[v] = sum_r J[r, v] * fvec[r]; rows split over groups of V threads.
// Ends with out written; the caller syncs before reading it.
__device__ inline void jt_apply(const float* J, const float* fvec, float* out, float* partial,
                                int E, int V, int Vs) {
  const int t = threadIdx.x;
  const int nparts = kThreads / V;
  if (t < nparts * V) {
    const int v = t % V, part = t / V;
    float s = 0.0f;
    for (int r = part; r < E; r += nparts) s += J[r * Vs + v] * fvec[r];
    partial[part * V + v] = s;
  }
  __syncthreads();
  if (t < V) {
    float s = 0.0f;
    for (int q = 0; q < nparts; ++q) s += partial[q * V + t];
    out[t] = s;
  }
}

// The CG solve from x (the warmstart) and jar = J x - aref, both in shared
// memory and synced; leaves the solution in x and jar, synced.
__device__ inline void cg_iterate(const Smem& s, int E, int V, int iterations) {
  const int t = threadIdx.x;
  const int Vs = row_stride(V);
  const float* J = s.J;
  const float* M = s.mat;
  const float* Minv = s.mat + (size_t)V * Vs;

  // g = M (x - qs) + J^T force(jar); Mg = M^-1 g; p = -Mg
  for (int r = t; r < E; r += kThreads) s.fr[r] = force_of(s.jar[r], row_w(s, r));
  for (int i = t; i < V; i += kThreads) s.dx[i] = s.x[i] - s.qs[i];
  __syncthreads();
  jt_apply(J, s.fr, s.gn, s.partial, E, V, Vs);
  __syncthreads();
  for (int i = t; i < V; i += kThreads) s.g[i] = dotn(M + i * Vs, s.dx, V) + s.gn[i];
  __syncthreads();
  for (int i = t; i < V; i += kThreads) {
    s.Mg[i] = dotn(Minv + i * Vs, s.g, V);
    s.pd[i] = -s.Mg[i];
  }
  __syncthreads();

  const float scales[4] = {2.0f, 1.0f, 0.5f, 0.125f};
  for (int it = 0; it < iterations; ++it) {
    for (int r = t; r < E; r += kThreads) s.Jp[r] = dotn(J + r * Vs, s.pd, V);
    for (int i = t; i < V; i += kThreads) s.Mp[i] = dotn(M + i * Vs, s.pd, V);
    __syncthreads();

    // c1, c2, f0.Jp, deff.Jp.Jp, penalty at a = 0
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = t; i < V; i += kThreads) {
      acc[0] += (s.x[i] - s.qs[i]) * s.Mp[i];
      acc[1] += s.pd[i] * s.Mp[i];
    }
    for (int r = t; r < E; r += kThreads) {
      const RowW w = row_w(s, r);
      const float j = s.jar[r], jp = s.Jp[r];
      const float neg = j < 0.0f ? 1.0f : 0.0f;
      const float inside = fabsf(w.dfr * j) < w.floss ? 1.0f : 0.0f;
      const float deff = (w.deq + w.done * neg) + w.dfr * inside;
      acc[2] += force_of(j, w) * jp;
      acc[3] += deff * jp * jp;
      acc[4] += penalty_of(j, w);
    }
    block_sum<5>(acc, s.red);
    const float c1 = acc[0], c2 = acc[1];
    const float phi_p = c1 + acc[2];
    const float phi_pp = fmaxf(c2 + acc[3], 1e-12f);
    const float a1 = fminf(fmaxf(-phi_p / phi_pp, 0.0f), 2.0f);
    const float pen0 = acc[4];

    float pen[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = t; r < E; r += kThreads) {
      const RowW w = row_w(s, r);
#pragma unroll
      for (int k = 0; k < 4; ++k) pen[k] += penalty_of(s.jar[r] + (a1 * scales[k]) * s.Jp[r], w);
    }
    block_sum<4>(pen, s.red);
    float best_cost = 0.0f, best_a = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = a1 * scales[k];
      const float dcost = a * c1 + 0.5f * a * a * c2 + pen[k] - pen0;
      if (dcost < best_cost) {
        best_cost = dcost;
        best_a = a;
      }
    }

    for (int i = t; i < V; i += kThreads) {
      s.x[i] = s.x[i] + best_a * s.pd[i];
      s.dx[i] = s.x[i] - s.qs[i];
    }
    for (int r = t; r < E; r += kThreads) {
      s.jar[r] = s.jar[r] + best_a * s.Jp[r];
      s.fr[r] = force_of(s.jar[r], row_w(s, r));
    }
    __syncthreads();
    jt_apply(J, s.fr, s.Mgn, s.partial, E, V, Vs);
    __syncthreads();
    for (int i = t; i < V; i += kThreads) s.gn[i] = dotn(M + i * Vs, s.dx, V) + s.Mgn[i];
    __syncthreads();
    float nd[2] = {0.0f, 0.0f};
    for (int i = t; i < V; i += kThreads) {
      s.Mgn[i] = dotn(Minv + i * Vs, s.gn, V);
      nd[0] += s.gn[i] * (s.Mgn[i] - s.Mg[i]);
      nd[1] += s.g[i] * s.Mg[i];
    }
    block_sum<2>(nd, s.red);
    const float beta = fmaxf(nd[0] / fmaxf(nd[1], 1e-12f), 0.0f);
    for (int i = t; i < V; i += kThreads) {
      s.pd[i] = -s.Mgn[i] + beta * s.pd[i];
      s.g[i] = s.gn[i];
      s.Mg[i] = s.Mgn[i];
    }
    __syncthreads();
  }
}

// f = -force(jar) into fr and out (the env's E rows); x into x_out.
__device__ inline void write_solution(const Smem& s, int E, int V, float* f_out, float* x_out) {
  const int t = threadIdx.x;
  for (int r = t; r < E; r += kThreads) {
    const float fv = -force_of(s.jar[r], row_w(s, r));
    s.fr[r] = fv;
    f_out[r] = fv;
  }
  for (int i = t; i < V; i += kThreads) x_out[i] = s.x[i];
}

}  // namespace cg_common
