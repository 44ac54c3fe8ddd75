// Fused constraint solve for Hopper (sm_90a): contact rows of J, aref, the
// regularizer, M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search, J^T f, and the implicit-damping
// Euler velocity update with one refinement step.
//
// Replaces robogym_tpu/physics/cg_kernel.py:_cg_full_kernel (with
// _build_rows and _line_search_step) in its two variants: with the Euler
// update, qacc_smooth and the warmstart (step's fused solve, entry point
// robogym_cg_full), and without them, qacc_smooth and the warmstart given
// (forward()'s solve, robogym_cg_full_noeuler). The CG loop itself is in
// cg_common.cuh, which kernel F (cg.cu) shares.
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
// facet-minor; a model with no scalar rows has n_s = 0), M, M^-1 and, with
// the Euler update, M + dt*D and its inverse stay in shared memory for the
// whole solve, with an odd row stride so that one thread per row reads
// without bank conflicts.

#include "cg_common.cuh"

namespace {

using namespace cg_common;

constexpr int kEq = 0;
constexpr int kOneSided = 1;
constexpr int kFriction = 2;

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
  const float* Mimp;      // with the Euler update only
  const float* Minv_imp;
  const float* qvel;      // (B, V)
  const float* qfrc_smooth;  // with the Euler update
  const float* qacc_prev;
  const float* qs_in;        // without it: qacc_smooth and the warmstart
  const float* x0;
  const int* kind;        // (E,) row kinds
  const float* dt;        // (1,)
  float* x;               // (B, V) qacc
  float* f;               // (B, E) efc force
  float* qfrc;            // (B, V) J^T f
  float* qvel_new;        // (B, V), with the Euler update
  float* qs;              // (B, V) qacc_smooth, with the Euler update
  int n_s, S, F, V, iterations;
};

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

template <bool kEuler>
__global__ void __launch_bounds__(kThreads) cg_full_kernel(Params p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, t = threadIdx.x;
  const int V = p.V, F = p.F, n_s = p.n_s;
  const int E = n_s + p.S * F;
  const int Vs = row_stride(V);
  const Smem s = carve(sm, E, V, kEuler ? 4 : 2);
  float* J = s.J;
  float* M = s.mat;
  float* Minv = M + V * Vs;
  float* Mimp = Minv + V * Vs;
  float* Minvimp = Mimp + V * Vs;

  const size_t bVV = (size_t)b * V * V;
  for (int idx = t; idx < V * V; idx += kThreads) {
    const int i = idx / V, j = idx % V;
    M[i * Vs + j] = p.M[bVV + idx];
    Minv[i * Vs + j] = p.Minv[bVV + idx];
    if (kEuler) {
      Mimp[i * Vs + j] = p.Mimp[bVV + idx];
      Minvimp[i * Vs + j] = p.Minv_imp[bVV + idx];
    }
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
    const int kd = p.kind[r];
    const float D = p.active[bE + r] > 0.0f ? 1.0f / p.rcoef[bE + r] : 0.0f;
    s.deq[r] = kd == kEq ? D : 0.0f;
    s.done[r] = kd == kOneSided ? D : 0.0f;
    s.dfr[r] = kd == kFriction ? D : 0.0f;
    s.fl[r] = p.floss[bE + r];
  }
  const size_t bV = (size_t)b * V;
  for (int i = t; i < V; i += kThreads) {
    s.qv[i] = p.qvel[bV + i];
    if (kEuler) {
      s.gn[i] = p.qfrc_smooth[bV + i];
      s.dx[i] = p.qacc_prev[bV + i];
    } else {
      s.qs[i] = p.qs_in[bV + i];
      s.x[i] = p.x0[bV + i];
    }
  }
  __syncthreads();

  if (kEuler) {
    // qacc_smooth = M^-1 qfrc_smooth; warmstart from qacc_prev when finite
    float bad[1] = {0.0f};
    for (int i = t; i < V; i += kThreads) {
      s.qs[i] = dotn(Minv + i * Vs, s.gn, V);
      p.qs[bV + i] = s.qs[i];
      if (!(fabsf(s.dx[i]) < 1e10f)) bad[0] += 1.0f;
    }
    block_sum<1>(bad, s.red);
    const bool finite = bad[0] == 0.0f;
    for (int i = t; i < V; i += kThreads) s.x[i] = finite ? s.dx[i] : s.qs[i];
    __syncthreads();
  }

  // jar = J x0 - aref, aref = -bref * J qvel - kimp * pos
  for (int r = t; r < E; r += kThreads) {
    const float* Jr = J + r * Vs;
    const float aref = -p.bref[bE + r] * dotn(Jr, s.qv, V) - p.kimp[bE + r] * p.pos[bE + r];
    s.jar[r] = dotn(Jr, s.x, V) - aref;
  }
  __syncthreads();

  cg_iterate(s, E, V, p.iterations);

  // f = -force(jar), qfrc = J^T f
  write_solution(s, E, V, p.f + bE, p.x + bV);
  __syncthreads();
  jt_apply(J, s.fr, s.gn, s.partial, E, V, Vs);
  __syncthreads();
  for (int i = t; i < V; i += kThreads) p.qfrc[bV + i] = s.gn[i];

  if (kEuler) {
    // implicit-damping Euler: qacc = Mimp^-1 M x with one refinement step
    for (int i = t; i < V; i += kThreads) s.Mp[i] = dotn(M + i * Vs, s.x, V);
    __syncthreads();
    for (int i = t; i < V; i += kThreads) s.Mg[i] = dotn(Minvimp + i * Vs, s.Mp, V);
    __syncthreads();
    for (int i = t; i < V; i += kThreads) s.dx[i] = s.Mp[i] - dotn(Mimp + i * Vs, s.Mg, V);
    __syncthreads();
    const float dt = p.dt[0];
    for (int i = t; i < V; i += kThreads) {
      const float qacc_imp = s.Mg[i] + dotn(Minvimp + i * Vs, s.dx, V);
      p.qvel_new[bV + i] = s.qv[i] + dt * qacc_imp;
    }
  }
}

template <bool kEuler>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (p.V < 1 || p.V > kThreads || p.S < 0 || p.n_s < 0) return (int)cudaErrorInvalidValue;
  const int E = p.n_s + p.S * p.F;
  const size_t smem = smem_floats(E, p.V, kEuler ? 4 : 2) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_full_kernel<kEuler>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cg_full_kernel<kEuler><<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block of a CG kernel takes for E rows, V dofs
// and nmat (V, V) matrices: 4 for cg_full, 2 for cg_full_noeuler and cg.
extern "C" long long robogym_cg_smem_bytes(int E, int V, int nmat) {
  return (long long)(smem_floats(E, V, nmat) * sizeof(float));
}

// Both entry points return cudaErrorInvalidValue, and launch nothing, when
// V > 256 or the system does not fit in one block's shared memory.
extern "C" int robogym_cg_full(
    const float* Js, const float* off1, const float* off2, const float* frame, const float* fric,
    const float* m1, const float* m2, const float* cdof, const float* pos, const float* kimp,
    const float* bref, const float* rcoef, const float* active, const float* floss,
    const float* M, const float* Minv, const float* Mimp, const float* Minv_imp,
    const float* qvel, const float* qfrc_smooth, const float* qacc_prev, const int* kind,
    const float* dt, float* x, float* f, float* qfrc, float* qvel_new, float* qs,
    int B, int n_s, int S, int F, int V, int iterations, cudaStream_t stream) {
  Params p{Js, off1, off2, frame, fric, m1, m2, cdof, pos, kimp, bref, rcoef, active, floss,
           M, Minv, Mimp, Minv_imp, qvel, qfrc_smooth, qacc_prev, nullptr, nullptr, kind, dt,
           x, f, qfrc, qvel_new, qs, n_s, S, F, V, iterations};
  return launch<true>(p, B, stream);
}

extern "C" int robogym_cg_full_noeuler(
    const float* Js, const float* off1, const float* off2, const float* frame, const float* fric,
    const float* m1, const float* m2, const float* cdof, const float* pos, const float* kimp,
    const float* bref, const float* rcoef, const float* active, const float* floss,
    const float* M, const float* Minv, const float* qvel, const float* qs, const float* x0,
    const int* kind, float* x, float* f, float* qfrc,
    int B, int n_s, int S, int F, int V, int iterations, cudaStream_t stream) {
  Params p{Js, off1, off2, frame, fric, m1, m2, cdof, pos, kimp, bref, rcoef, active, floss,
           M, Minv, nullptr, nullptr, qvel, nullptr, nullptr, qs, x0, kind, nullptr,
           x, f, qfrc, nullptr, nullptr, n_s, S, F, V, iterations};
  return launch<false>(p, B, stream);
}
