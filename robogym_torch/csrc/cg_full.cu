// Fused constraint solve for Hopper (sm_90a): contact rows of J, aref, the
// regularizer, M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search, J^T f, and the implicit-damping
// Euler velocity update with one refinement step.
//
// Replaces robogym_tpu/physics/cg_kernel.py:_cg_full_kernel (with
// _build_rows and _line_search_step).
//
// Bound on this card: per env the kernel reads about 40 KB (the four
// (V, V) matrices, the gathered contact data, the row maps) and writes a
// few hundred bytes, and does about 15 * 6 * E * V flops, so the roofline
// bound is tens of microseconds at B=1024. What bounds a simple kernel is
// the chain of dependent steps: 15 iterations of a handful of matvecs and
// block reductions, each closed by a barrier.
//
// Design: one thread block per env. J (E x V, built here from the gathered
// contact data exactly as the plain version builds it, contact-major and
// facet-minor), M, M^-1, M + dt*D and its inverse stay in shared memory for
// the whole solve, with an odd row stride so that one thread per row reads
// without bank conflicts. J x and M x take a thread per row; J^T f splits
// the rows over thread groups and sums the partials; the dot products and
// the five line-search costs are block reductions that every thread reads
// back, so the line search and the Polak-Ribiere step run uniformly in
// every thread. The order of the arithmetic inside each row and dof follows
// the plain version; only the order of the sums differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 64;          // floats of reduction scratch
constexpr int kEq = 0;
constexpr int kOneSided = 1;
constexpr int kFriction = 2;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one block may opt into on Hopper

struct Params {
  const float* Js;        // (B, n_s, V)
  const float* off1;      // (B, S, 3)
  const float* off2;      // (B, S, 3)
  const float* frame;     // (B, S, 9) normal | tangent1 | tangent2
  const float* fric;      // (B, S, 5)
  const float* m1;        // (B, S, V)
  const float* m2;        // (B, S, V)
  const float* cdof;      // (B, V, 6)
  const float* pos;       // (B, E) row maps
  const float* kimp;
  const float* bref;
  const float* rcoef;
  const float* active;
  const float* floss;
  const float* M;         // (B, V, V)
  const float* Minv;
  const float* Mimp;
  const float* Minv_imp;
  const float* qvel;      // (B, V)
  const float* qfrc_smooth;
  const float* qacc_prev;
  const int* kind;        // (E,) row kinds
  const float* dt;        // (1,)
  float* x;               // (B, V) qacc
  float* f;               // (B, E) efc force
  float* qfrc;            // (B, V) J^T f
  float* qvel_new;        // (B, V)
  float* qs;              // (B, V) qacc_smooth
  int n_s, S, F, V, iterations;
};

__host__ __device__ inline int row_stride(int V) { return (V % 2 == 0) ? V + 1 : V; }

__host__ inline size_t smem_floats(int E, int V) {
  const int Vs = row_stride(V);
  return (size_t)E * Vs + 4 * (size_t)V * Vs + 6 * (size_t)E + 10 * (size_t)V + kThreads + kRed;
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

__device__ __forceinline__ RowW row_weights(int kind, float D, float floss) {
  RowW w;
  w.deq = kind == kEq ? D : 0.0f;
  w.done = kind == kOneSided ? D : 0.0f;
  w.dfr = kind == kFriction ? D : 0.0f;
  w.floss = floss;
  return w;
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
__device__ void jt_apply(const float* J, const float* fvec, float* out, float* partial,
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

// One pyramid facet entry of the contact rows (the plain contact_rows).
__device__ float facet_entry(const Params& p, int b, int s, int k, int v) {
  const int S = p.S, V = p.V, F = p.F;
  const float* cd = p.cdof + ((size_t)b * V + v) * 6;
  const float a0 = cd[0], a1 = cd[1], a2 = cd[2];
  const float l0 = cd[3], l1 = cd[4], l2 = cd[5];
  const float* o1 = p.off1 + ((size_t)b * S + s) * 3;
  const float* o2 = p.off2 + ((size_t)b * S + s) * 3;
  const float mm1 = p.m1[((size_t)b * S + s) * V + v];
  const float mm2 = p.m2[((size_t)b * S + s) * V + v];
  const float* fr = p.frame + ((size_t)b * S + s) * 9;
  const float* fc = p.fric + ((size_t)b * S + s) * 5;
  // jac = (lin + cross(ang, off)) * mask
  const float j10 = (l0 + (a1 * o1[2] - a2 * o1[1])) * mm1;
  const float j11 = (l1 + (a2 * o1[0] - a0 * o1[2])) * mm1;
  const float j12 = (l2 + (a0 * o1[1] - a1 * o1[0])) * mm1;
  const float j20 = (l0 + (a1 * o2[2] - a2 * o2[1])) * mm2;
  const float j21 = (l1 + (a2 * o2[0] - a0 * o2[2])) * mm2;
  const float j22 = (l2 + (a0 * o2[1] - a1 * o2[0])) * mm2;
  const float r0 = j20 - j10, r1 = j21 - j11, r2 = j22 - j12;
  const float Jn = (fr[0] * r0 + fr[1] * r1) + fr[2] * r2;
  if (F == 1) return Jn;
  if (k < 4) {
    const int row = k < 2 ? 1 : 2;
    const float Jt = (fr[3 * row] * r0 + fr[3 * row + 1] * r1) + fr[3 * row + 2] * r2;
    const float mu = fc[k < 2 ? 0 : 1];
    return (k % 2 == 0) ? Jn + mu * Jt : Jn - mu * Jt;
  }
  const float dm = mm2 - mm1;
  const float q0 = a0 * dm, q1 = a1 * dm, q2 = a2 * dm;
  const int row = k < 6 ? 0 : (k < 8 ? 1 : 2);
  const float Jr = (fr[3 * row] * q0 + fr[3 * row + 1] * q1) + fr[3 * row + 2] * q2;
  const float mu = fc[k < 6 ? 2 : (k < 8 ? 3 : 4)];
  return (k % 2 == 0) ? Jn + mu * Jr : Jn - mu * Jr;
}

__global__ void __launch_bounds__(kThreads) cg_full_kernel(Params p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, t = threadIdx.x;
  const int V = p.V, F = p.F, n_s = p.n_s;
  const int E = n_s + p.S * F;
  const int Vs = row_stride(V);

  float* J = sm;
  float* M = J + (size_t)E * Vs;
  float* Minv = M + V * Vs;
  float* Mimp = Minv + V * Vs;
  float* Minvimp = Mimp + V * Vs;
  float* Dv = Minvimp + V * Vs;    // per row: D, floss, jar, Jp, force, kind
  float* fl = Dv + E;
  float* jar = fl + E;
  float* Jp = jar + E;
  float* fr = Jp + E;
  int* kd = reinterpret_cast<int*>(fr + E);
  float* x = reinterpret_cast<float*>(kd + E);   // per dof
  float* qs = x + V;
  float* pd = qs + V;
  float* g = pd + V;
  float* Mg = g + V;
  float* gn = Mg + V;
  float* Mgn = gn + V;
  float* Mp = Mgn + V;
  float* dx = Mp + V;
  float* qv = dx + V;
  float* partial = qv + V;
  float* red = partial + kThreads;

  const size_t bVV = (size_t)b * V * V;
  for (int idx = t; idx < V * V; idx += kThreads) {
    const int i = idx / V, j = idx % V;
    M[i * Vs + j] = p.M[bVV + idx];
    Minv[i * Vs + j] = p.Minv[bVV + idx];
    Mimp[i * Vs + j] = p.Mimp[bVV + idx];
    Minvimp[i * Vs + j] = p.Minv_imp[bVV + idx];
  }
  for (int idx = t; idx < n_s * V; idx += kThreads) {
    J[(idx / V) * Vs + idx % V] = p.Js[(size_t)b * n_s * V + idx];
  }
  for (int idx = t; idx < p.S * F * V; idx += kThreads) {
    const int rc = idx / V, v = idx % V;
    J[(n_s + rc) * Vs + v] = facet_entry(p, b, rc / F, rc % F, v);
  }
  const size_t bE = (size_t)b * E;
  for (int r = t; r < E; r += kThreads) {
    kd[r] = p.kind[r];
    Dv[r] = p.active[bE + r] > 0.0f ? 1.0f / p.rcoef[bE + r] : 0.0f;
    fl[r] = p.floss[bE + r];
  }
  const size_t bV = (size_t)b * V;
  for (int i = t; i < V; i += kThreads) {
    qv[i] = p.qvel[bV + i];
    gn[i] = p.qfrc_smooth[bV + i];
    dx[i] = p.qacc_prev[bV + i];
  }
  __syncthreads();

  // qacc_smooth = M^-1 qfrc_smooth; warmstart from qacc_prev when finite
  float bad[1] = {0.0f};
  for (int i = t; i < V; i += kThreads) {
    qs[i] = dotn(Minv + i * Vs, gn, V);
    p.qs[bV + i] = qs[i];
    if (!(fabsf(dx[i]) < 1e10f)) bad[0] += 1.0f;
  }
  block_sum<1>(bad, red);
  const bool finite = bad[0] == 0.0f;
  for (int i = t; i < V; i += kThreads) x[i] = finite ? dx[i] : qs[i];
  __syncthreads();

  // jar = J x0 - aref, aref = -bref * J qvel - kimp * pos
  for (int r = t; r < E; r += kThreads) {
    const float* Jr = J + r * Vs;
    const float aref = -p.bref[bE + r] * dotn(Jr, qv, V) - p.kimp[bE + r] * p.pos[bE + r];
    jar[r] = dotn(Jr, x, V) - aref;
  }
  __syncthreads();

  // g = M (x - qs) + J^T force(jar); Mg = M^-1 g; p = -Mg
  for (int r = t; r < E; r += kThreads) fr[r] = force_of(jar[r], row_weights(kd[r], Dv[r], fl[r]));
  for (int i = t; i < V; i += kThreads) dx[i] = x[i] - qs[i];
  __syncthreads();
  jt_apply(J, fr, gn, partial, E, V, Vs);
  __syncthreads();
  for (int i = t; i < V; i += kThreads) g[i] = dotn(M + i * Vs, dx, V) + gn[i];
  __syncthreads();
  for (int i = t; i < V; i += kThreads) {
    Mg[i] = dotn(Minv + i * Vs, g, V);
    pd[i] = -Mg[i];
  }
  __syncthreads();

  const float scales[4] = {2.0f, 1.0f, 0.5f, 0.125f};
  for (int it = 0; it < p.iterations; ++it) {
    for (int r = t; r < E; r += kThreads) Jp[r] = dotn(J + r * Vs, pd, V);
    for (int i = t; i < V; i += kThreads) Mp[i] = dotn(M + i * Vs, pd, V);
    __syncthreads();

    // c1, c2, f0.Jp, deff.Jp.Jp, penalty at a = 0
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = t; i < V; i += kThreads) {
      acc[0] += (x[i] - qs[i]) * Mp[i];
      acc[1] += pd[i] * Mp[i];
    }
    for (int r = t; r < E; r += kThreads) {
      const RowW w = row_weights(kd[r], Dv[r], fl[r]);
      const float j = jar[r], jp = Jp[r];
      const float neg = j < 0.0f ? 1.0f : 0.0f;
      const float inside = fabsf(w.dfr * j) < w.floss ? 1.0f : 0.0f;
      const float deff = (w.deq + w.done * neg) + w.dfr * inside;
      acc[2] += force_of(j, w) * jp;
      acc[3] += deff * jp * jp;
      acc[4] += penalty_of(j, w);
    }
    block_sum<5>(acc, red);
    const float c1 = acc[0], c2 = acc[1];
    const float phi_p = c1 + acc[2];
    const float phi_pp = fmaxf(c2 + acc[3], 1e-12f);
    const float a1 = fminf(fmaxf(-phi_p / phi_pp, 0.0f), 2.0f);
    const float pen0 = acc[4];

    float pen[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = t; r < E; r += kThreads) {
      const RowW w = row_weights(kd[r], Dv[r], fl[r]);
#pragma unroll
      for (int s = 0; s < 4; ++s) pen[s] += penalty_of(jar[r] + (a1 * scales[s]) * Jp[r], w);
    }
    block_sum<4>(pen, red);
    float best_cost = 0.0f, best_a = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float a = a1 * scales[s];
      const float dcost = a * c1 + 0.5f * a * a * c2 + pen[s] - pen0;
      if (dcost < best_cost) {
        best_cost = dcost;
        best_a = a;
      }
    }

    for (int i = t; i < V; i += kThreads) {
      x[i] = x[i] + best_a * pd[i];
      dx[i] = x[i] - qs[i];
    }
    for (int r = t; r < E; r += kThreads) {
      jar[r] = jar[r] + best_a * Jp[r];
      fr[r] = force_of(jar[r], row_weights(kd[r], Dv[r], fl[r]));
    }
    __syncthreads();
    jt_apply(J, fr, Mgn, partial, E, V, Vs);
    __syncthreads();
    for (int i = t; i < V; i += kThreads) gn[i] = dotn(M + i * Vs, dx, V) + Mgn[i];
    __syncthreads();
    float nd[2] = {0.0f, 0.0f};
    for (int i = t; i < V; i += kThreads) {
      Mgn[i] = dotn(Minv + i * Vs, gn, V);
      nd[0] += gn[i] * (Mgn[i] - Mg[i]);
      nd[1] += g[i] * Mg[i];
    }
    block_sum<2>(nd, red);
    const float beta = fmaxf(nd[0] / fmaxf(nd[1], 1e-12f), 0.0f);
    for (int i = t; i < V; i += kThreads) {
      pd[i] = -Mgn[i] + beta * pd[i];
      g[i] = gn[i];
      Mg[i] = Mgn[i];
    }
    __syncthreads();
  }

  // f = -force(jar), qfrc = J^T f
  for (int r = t; r < E; r += kThreads) {
    const float fv = -force_of(jar[r], row_weights(kd[r], Dv[r], fl[r]));
    fr[r] = fv;
    p.f[bE + r] = fv;
  }
  for (int i = t; i < V; i += kThreads) p.x[bV + i] = x[i];
  __syncthreads();
  jt_apply(J, fr, gn, partial, E, V, Vs);
  __syncthreads();

  // implicit-damping Euler: qacc = Mimp^-1 M x with one refinement step
  for (int i = t; i < V; i += kThreads) {
    p.qfrc[bV + i] = gn[i];
    Mp[i] = dotn(M + i * Vs, x, V);
  }
  __syncthreads();
  for (int i = t; i < V; i += kThreads) Mg[i] = dotn(Minvimp + i * Vs, Mp, V);
  __syncthreads();
  for (int i = t; i < V; i += kThreads) dx[i] = Mp[i] - dotn(Mimp + i * Vs, Mg, V);
  __syncthreads();
  const float dt = p.dt[0];
  for (int i = t; i < V; i += kThreads) {
    const float qacc_imp = Mg[i] + dotn(Minvimp + i * Vs, dx, V);
    p.qvel_new[bV + i] = qv[i] + dt * qacc_imp;
  }
}

}  // namespace

// Dynamic shared memory one block of the kernel takes for E rows and V dofs.
extern "C" long long robogym_cg_full_smem_bytes(int E, int V) {
  return (long long)(smem_floats(E, V) * sizeof(float));
}

// Returns cudaErrorInvalidValue, and launches nothing, when V > 256 or the
// system does not fit in one block's shared memory.
extern "C" int robogym_cg_full(
    const float* Js, const float* off1, const float* off2, const float* frame, const float* fric,
    const float* m1, const float* m2, const float* cdof, const float* pos, const float* kimp,
    const float* bref, const float* rcoef, const float* active, const float* floss,
    const float* M, const float* Minv, const float* Mimp, const float* Minv_imp,
    const float* qvel, const float* qfrc_smooth, const float* qacc_prev, const int* kind,
    const float* dt, float* x, float* f, float* qfrc, float* qvel_new, float* qs,
    int B, int n_s, int S, int F, int V, int iterations, cudaStream_t stream) {
  if (V < 1 || V > kThreads || S < 0 || n_s < 0) return (int)cudaErrorInvalidValue;
  const int E = n_s + S * F;
  const size_t smem = smem_floats(E, V) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_full_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{Js, off1, off2, frame, fric, m1, m2, cdof, pos, kimp, bref, rcoef, active, floss,
           M, Minv, Mimp, Minv_imp, qvel, qfrc_smooth, qacc_prev, kind, dt,
           x, f, qfrc, qvel_new, qs, n_s, S, F, V, iterations};
  cg_full_kernel<<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
