// Constraint CG solve on a prebuilt Jacobian for Hopper (sm_90a): from J,
// aref, the row weights D masked by kind (Deq, Done, Dfr) and the friction
// losses, M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search; returns qacc and the row forces.
//
// Replaces robogym_tpu/physics/cg_kernel.py:_cg_kernel (the solve that
// constraint._make_cg_core dispatches to: forward_tail's solve on a model
// with no contact slots), and, above kernel B's shared memory, the solve of
// the XLA route that constraint_batched.py takes for oversized systems.
//
// Bound on this card: per env the kernel reads J (E x V), the two (V, V)
// matrices and the row vectors once and writes x and f; at E = V = 24 that
// is about 7 KB and some 15 * (4 E V + 6 V V) flops, a few microseconds at
// B=1024. What bounds it is the chain of dependent steps in each env's
// solve: 15 iterations of matvecs and reductions, each needing the last.
//
// Design: kernel B's (cg_full.cu): one warp per env (a block of 32
// threads), no block barrier, B=1024 envs resident at once; the loop is
// cg_common.cuh's `cg_solve`, so B and F do the same arithmetic in the same
// order. Two instantiations, picked from E and V before the launch:
//  - J in shared memory (when the env's arrays fit in a block's 227 KB):
//    J staged by column with the odd stride CS = 32 n + 1 from the (B, E,
//    V) input with coalesced loads, 16 in flight a lane; M and M^-1 rows in
//    registers for V <= 32 (staged through J's region), else in shared
//    memory; the row forces and the row slots past the R register rows in
//    shared memory.
//  - J in device memory, in its row-major layout, for any size: J p with
//    lane = row, J^T f with lane = dof, coalesced, in the same order as the
//    first; the row forces and spilled row slots in a device scratch buffer
//    the caller allocates (`robogym_cg_scratch_floats`); M and M^-1 read
//    in place, so the route takes no shared memory and 12 envs an SM at
//    V = 96 (staged in shared memory they held it to 3, and it ran slower).
// Row weights come premasked and are kept so (`MaskedW`); spilled rows
// read theirs from the inputs.

#include <type_traits>

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
  float* scratch;      // (B, scratch floats), J in device memory only
  float* trace;        // (B, iterations + 1, trace_floats) or null
  int E, V, iterations;
};

// Rows a lane keeps in registers (row slots past them spill).
__host__ __device__ inline int reg_rows(int E, int V, bool dev) {
  const int nk = (E + 31) / 32;
  if (dev || V > 32) return 4;
  return nk <= 1 ? 1 : nk <= 2 ? 2 : 4;
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Where an env's arrays live, in floats. J in shared memory: J's region (J
// by column, or M and M^-1 staged for V <= 32), the two matrices for V >
// 32, the row forces (16-byte aligned), then the spilled row slots (jar,
// J p). J in device memory: nothing; the row forces and spilled slots in
// the scratch buffer.
struct Layout {
  int Vs, nk, R, CS, nspill;
  size_t mats, f, spill, total, scratch;
};

__host__ __device__ inline Layout layout(int E, int V, bool dev) {
  Layout l;
  l.Vs = row_stride(V);
  l.nk = (E + 31) / 32;
  l.R = reg_rows(E, V, dev);
  l.CS = 32 * (l.nk > l.R ? l.nk : l.R) + 1;
  l.nspill = l.nk > l.R ? l.nk - l.R : 0;
  const size_t pair = 2 * (size_t)V * l.Vs;
  const size_t rows = round4(E) + 2 * 32 * (size_t)l.nspill;
  if (!dev) {
    const size_t jsize = (size_t)V * l.CS;
    l.mats = V <= 32 ? (jsize > pair ? jsize : pair) : jsize;
    l.f = round4(l.mats + (V > 32 ? pair : 0));
    l.spill = l.f + round4(E);
    l.total = l.f + rows;
    l.scratch = 0;
  } else {
    l.mats = l.total = l.f = 0;
    l.spill = round4(E);
    l.scratch = rows;
  }
  return l;
}

// J (E, V) row-major in device memory into shared memory by column (stride
// CS), rows E..CS - 2 zero; coalesced, 16 loads a lane in flight.
__device__ __forceinline__ void stage_cols(float* J, const float* src, int E, int V, int CS) {
  constexpr int kBatch = 16;
  const int n = E * V;
  for (int base = threadIdx.x; base < n; base += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 32 * u;
      v[u] = idx < n ? src[idx] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 32 * u;
      if (idx >= n) break;
      const int r = idx / V;
      J[(idx - r * V) * CS + r] = v[u];
    }
  }
  const int pad = CS - 1 - E;
  for (int idx = threadIdx.x; idx < V * pad; idx += 32) {
    const int c = idx / pad;
    J[c * CS + E + (idx - c * pad)] = 0.0f;
  }
}

// out = J v on the lane's row slots, J (E, V) row-major in device memory:
// lane = row, v_j by shuffle, in j_times's order; 0 past E.
template <int DPL, int R>
__device__ __forceinline__ void row_times(const float* J, int V, int E, int nk,
                                          const float (&v)[DPL], float (&out)[R], float* spill) {
  const int lane = threadIdx.x;
  const float* row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    out[k] = 0.0f;
    const int r = lane + 32 * k;
    row[k] = J + (size_t)(r < E ? r : 0) * V;
  }
#pragma unroll
  for (int q2 = 0; q2 < DPL; ++q2) {
    if (32 * q2 >= V) break;
    const int n = V - 32 * q2 < 32 ? V - 32 * q2 : 32;
#pragma unroll 2
    for (int j2 = 0; j2 < n; ++j2) {
      const float vj = __shfl_sync(kFull, v[q2], j2);
#pragma unroll
      for (int k = 0; k < R; ++k) out[k] += row[k][32 * q2 + j2] * vj;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (lane + 32 * k >= E) out[k] = 0.0f;
  for (int k = R; k < nk; ++k) {
    const int r = lane + 32 * k;
    const float* rw = J + (size_t)(r < E ? r : 0) * V;
    float s = 0.0f;
#pragma unroll
    for (int q2 = 0; q2 < DPL; ++q2) {
      if (32 * q2 >= V) break;
      const int n = V - 32 * q2 < 32 ? V - 32 * q2 : 32;
      for (int j2 = 0; j2 < n; ++j2) s += rw[32 * q2 + j2] * __shfl_sync(kFull, v[q2], j2);
    }
    spill[(k - R) * 32 + lane] = r < E ? s : 0.0f;
  }
}

// An env's system with J in device memory by row (`cg_solve`'s `sys`).
template <int DPL, int R>
struct RowSys {
  const float* J;
  int V, E, nk;
  float* fs;
  Rows<R, MaskedW<R>> rs;
  MaskedSpill sp;
  template <class Fn>
  __device__ __forceinline__ void rows(Fn&& fn) {
    for_rows(rs, sp, nk, fn);
  }
  __device__ __forceinline__ void jp(const float (&v)[DPL]) {
    row_times<DPL, R>(J, V, E, nk, v, rs.Jp, sp.Jp);
  }
  __device__ __forceinline__ void jtf(float (&out)[DPL]) {
    jt_times<DPL>(J, fs, E, V, 1, V, out);
  }
};

template <int DPL, int R, bool DEV>
__global__ void __launch_bounds__(32) cg_kernel(Params p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int E = p.E, V = p.V;
  const Layout L = layout(E, V, DEV);
  const int nk = L.nk;
  const size_t bVV = (size_t)b * V * V, bV = (size_t)b * V, bE = (size_t)b * E;
  const float* Jg = p.J + (size_t)b * E * V;

  // M and M^-1 (rows into registers for V <= 32): read in place with J in
  // device memory; else staged into shared memory (through J's region for
  // V <= 32), and then J staged by column
  Mat<DPL> M, Minv;
  const int Ms = DEV ? V : L.Vs;
  if (DEV) {
    M.load(p.M + bVV, V, Ms);
    Minv.load(p.Minv + bVV, V, Ms);
  } else {
    float* staged = DPL == 1 ? sm : sm + L.mats;
    stage_pair(staged, p.M + bVV, p.Minv + bVV, V, Ms);
    __syncwarp();
    M.load(staged, V, Ms);
    Minv.load(staged + V * Ms, V, Ms);
    __syncwarp();
    stage_cols(sm, Jg, E, V, L.CS);
    __syncwarp();
  }

  float* rowmem = DEV ? p.scratch + (size_t)b * L.scratch : sm + L.f;
  float* sp0 = rowmem + (L.spill - L.f);
  const int ns = 32 * L.nspill;
  const MaskedSpill sp{sp0, sp0 + ns, p.Deq + bE, p.Done + bE, p.Dfr + bE, p.floss + bE, E};
  using Sys = typename std::conditional<DEV, RowSys<DPL, R>,
                                        ColSys<DPL, R, MaskedW<R>, MaskedSpill>>::type;
  Sys sys = [&] {
    if constexpr (DEV) return Sys{Jg, V, E, nk, rowmem, {}, sp};
    else return Sys{sm, L.CS, V, E, nk, rowmem, {}, sp};
  }();
  Rows<R, MaskedW<R>>& rs = sys.rs;

  float x[DPL], qs[DPL];
  load_vec(p.qs + bV, qs, V);
  load_vec(p.x0 + bV, x, V);

  // row weights; jar = J x0 - aref
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = lane + 32 * k;
    const bool ok = r < E;
    rs.w.w[k] = ok ? RowW{p.Deq[bE + r], p.Done[bE + r], p.Dfr[bE + r], p.floss[bE + r]}
                   : RowW{0.0f, 0.0f, 0.0f, 0.0f};
  }
  sys.jp(x);
  auto jar0 = [&](int k, float& jar, float jx) {
    const int r = lane + 32 * k;
    jar = r < E ? jx - p.aref[bE + r] : 0.0f;
  };
#pragma unroll
  for (int k = 0; k < R; ++k) jar0(k, rs.jar[k], rs.Jp[k]);
  for (int k = R; k < nk; ++k) {
    const int i = (k - R) * 32 + lane;
    jar0(k, sp.jar[i], sp.Jp[i]);
  }

  float* tr = p.trace ? p.trace + (size_t)b * (p.iterations + 1) * trace_floats(V, E) : nullptr;
  cg_solve<DPL>(sys, M, Minv, x, qs, p.f + bE, V, Ms, p.iterations, tr);
  store_vec(p.x + bV, x, V);
}

using KernelFn = void (*)(Params);

KernelFn pick(int E, int V, bool dev) {
  if (dev) {
    if (V <= 32) return cg_kernel<1, 4, true>;
    if (V <= 64) return cg_kernel<2, 4, true>;
    if (V <= 128) return cg_kernel<4, 4, true>;
    return cg_kernel<8, 4, true>;
  }
  if (V <= 32) {
    switch (reg_rows(E, V, false)) {
      case 1: return cg_kernel<1, 1, false>;
      case 2: return cg_kernel<1, 2, false>;
      default: return cg_kernel<1, 4, false>;
    }
  }
  if (V <= 64) return cg_kernel<2, 4, false>;
  if (V <= 128) return cg_kernel<4, 4, false>;
  return cg_kernel<8, 4, false>;
}

// The route for E rows and V dofs: J in shared memory when the env's
// arrays fit there, else J in device memory.
bool device_route(int E, int V) { return layout(E, V, false).total * sizeof(float) > kMaxSmem; }

struct Plan {
  KernelFn fn;
  size_t smem;     // bytes of dynamic shared memory an env (a block)
  size_t scratch;  // floats of device scratch an env
};

// The kernel for E rows and V dofs on route `dev` with its dynamic shared
// memory set; cudaErrorInvalidValue when V is out of range.
cudaError_t configure(int E, int V, bool dev, Plan* pl) {
  if (V < 1 || V > kMaxV || E < 0) return cudaErrorInvalidValue;
  const Layout l = layout(E, V, dev);
  pl->fn = pick(E, V, dev);
  pl->smem = l.total * sizeof(float);
  pl->scratch = l.scratch;
  cudaError_t e = cudaFuncSetAttribute(pl->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl->smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(pl->fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Bytes of shared memory one block may use: the limit of both CG kernels'
// shared-memory layouts.
extern "C" long long robogym_max_smem_bytes() { return (long long)kMaxSmem; }

// Dynamic shared memory of one env (one block) of kernel F for E rows and
// V dofs, on the route it takes.
extern "C" long long robogym_cg_smem_bytes(int E, int V) {
  return (long long)(layout(E, V, device_route(E, V)).total * sizeof(float));
}

// Floats of device scratch an env of kernel F takes for E rows and V dofs:
// 0 when J fits in shared memory, else its row forces and spilled rows.
extern "C" long long robogym_cg_scratch_floats(int E, int V) {
  return (long long)layout(E, V, device_route(E, V)).scratch;
}

// Envs (blocks) of kernel F resident on one SM for E rows and V dofs; a
// negative CUDA error code on failure.
extern "C" int robogym_cg_blocks_per_sm(int E, int V) {
  Plan pl;
  cudaError_t e = configure(E, V, device_route(E, V), &pl);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pl.fn, 32, pl.smem);
  return e == cudaSuccess ? n : -(int)e;
}

// Returns cudaErrorInvalidValue, and launches nothing, when V > 256, E < 0,
// or the route needs device scratch and `scratch` is null. A non-null
// `trace` gets each env's solve state as kernel B's does (cg_full.cu).
extern "C" int robogym_cg(const float* J, const float* aref, const float* Deq, const float* Done,
                          const float* Dfr, const float* floss, const float* M, const float* Minv,
                          const float* qs, const float* x0, float* x, float* f, float* scratch,
                          float* trace, int B, int E, int V, int iterations, cudaStream_t stream) {
  Plan pl;
  const cudaError_t e = configure(E, V, device_route(E, V), &pl);
  if (e != cudaSuccess) return (int)e;
  if (pl.scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Params p{J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, x, f, scratch, trace, E, V,
           iterations};
  pl.fn<<<B, 32, pl.smem, stream>>>(p);
  return (int)cudaGetLastError();
}
