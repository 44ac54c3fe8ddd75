// Constraint CG solve on a prebuilt Jacobian for Hopper (sm_90a): from J,
// aref, the row weights D masked by kind (Deq, Done, Dfr) and the friction
// losses, M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search; returns qacc and the row forces.
//
// Replaces robogym_tpu/physics/cg_kernel.py:_cg_kernel (the solve that
// constraint._make_cg_core dispatches to: forward_tail's solve on a model
// with no contact slots).
//
// Bound on this card: per env the kernel reads J (E x V), the two (V, V)
// matrices and the row vectors once and writes x and f; at E = V = 24 that
// is about 7 KB and some 15 * (4 E V + 6 V V) flops, a few microseconds at
// B=1024. What bounds a simple kernel is the chain of dependent steps, as
// in kernel B.
//
// Design: one thread block per env; J, M and M^-1 in shared memory with an
// odd row stride; the CG loop is kernel B's (cg_common.cuh), so the two
// kernels do the same arithmetic.

#include "cg_common.cuh"

namespace {

using namespace cg_common;

struct Params {
  const float* J;      // (B, E, V)
  const float* aref;   // (B, E)
  const float* Deq;
  const float* Done;
  const float* Dfr;
  const float* floss;
  const float* M;      // (B, V, V)
  const float* Minv;
  const float* qs;     // (B, V)
  const float* x0;
  float* x;            // (B, V)
  float* f;            // (B, E)
  int E, V, iterations;
};

__global__ void __launch_bounds__(kThreads) cg_kernel(Params p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, t = threadIdx.x;
  const int E = p.E, V = p.V;
  const int Vs = row_stride(V);
  const Smem s = carve(sm, E, V, 2);
  float* M = s.mat;
  float* Minv = M + V * Vs;

  const size_t bVV = (size_t)b * V * V;
  for (int idx = t; idx < V * V; idx += kThreads) {
    const int i = idx / V, j = idx % V;
    M[i * Vs + j] = p.M[bVV + idx];
    Minv[i * Vs + j] = p.Minv[bVV + idx];
  }
  const size_t bEV = (size_t)b * E * V;
  for (int idx = t; idx < E * V; idx += kThreads) s.J[(idx / V) * Vs + idx % V] = p.J[bEV + idx];
  const size_t bE = (size_t)b * E;
  for (int r = t; r < E; r += kThreads) {
    s.deq[r] = p.Deq[bE + r];
    s.done[r] = p.Done[bE + r];
    s.dfr[r] = p.Dfr[bE + r];
    s.fl[r] = p.floss[bE + r];
  }
  const size_t bV = (size_t)b * V;
  for (int i = t; i < V; i += kThreads) {
    s.qs[i] = p.qs[bV + i];
    s.x[i] = p.x0[bV + i];
  }
  __syncthreads();

  // jar = J x0 - aref
  for (int r = t; r < E; r += kThreads) s.jar[r] = dotn(s.J + r * Vs, s.x, V) - p.aref[bE + r];
  __syncthreads();

  cg_iterate(s, E, V, p.iterations);
  write_solution(s, E, V, p.f + bE, p.x + bV);
}

}  // namespace

// Returns cudaErrorInvalidValue, and launches nothing, when V > 256 or the
// system does not fit in one block's shared memory.
extern "C" int robogym_cg(const float* J, const float* aref, const float* Deq, const float* Done,
                          const float* Dfr, const float* floss, const float* M, const float* Minv,
                          const float* qs, const float* x0, float* x, float* f,
                          int B, int E, int V, int iterations, cudaStream_t stream) {
  if (V < 1 || V > kThreads || E < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(E, V, 2) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, x, f, E, V, iterations};
  cg_kernel<<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
