// Fused constraint solve for Hopper (sm_90a): contact rows of J, aref, the
// regularizer, M^-1-preconditioned Polak-Ribiere+ nonlinear CG with the
// frozen-active-set Newton line search, J^T f, and the implicit-damping
// Euler velocity update with one refinement step.
//
// Replaces robogym_tpu/physics/cg_kernel.py:_cg_full_kernel (with
// _build_rows and _line_search_step) in its two variants: with the Euler
// update, qacc_smooth and the warmstart (step's fused solve, entry point
// robogym_cg_full), and without them, qacc_smooth and the warmstart given
// (forward()'s solve, robogym_cg_full_noeuler).
//
// Bound on this card: per env the kernel reads about 40 KB (the four
// (V, V) matrices, the gathered contact data, the row maps) and writes a
// few hundred bytes, and does about 15 * 6 * E * V flops, so the roofline
// bound is about ten microseconds at B=1024. What bounds it is the chain of
// dependent steps in each env's solve: 15 iterations of matvecs and
// reductions, each of which needs the one before, and in the set-up the
// latency of its loads from device memory.
//
// Design: one warp per env (a block of 32 threads, blockIdx.x = env), so
// that no step of the solve waits on a block barrier, and B=1024 envs are
// resident at once: reductions are butterfly shuffles, which leave the
// same sum in every lane, and lanes exchange data through shared memory
// behind __syncwarp.
//  - Lane = dof: lane i holds dofs i, i + 32, ... (DPL a lane, 1, 2, 4 or
//    8, so V <= 256) of every per-dof vector in registers; M v and M^-1 v
//    take row i in lane i and v_j by shuffle. For V <= 32 the rows of M and
//    M^-1 live in registers, staged through J's region with coalesced
//    loads; above that the two matrices stay in shared memory.
//  - Lane = rows r = lane (mod 32): jar, J p, D and the friction loss of
//    the first R rows a lane (a template parameter) live in registers, with
//    the row kinds packed two bits a row; the rest in shared memory.
//  - J (E x V; n_s may be 0) is the only per-env array in shared memory for
//    V <= 32. It is stored by column, with an odd column stride CS = 32 n +
//    1 (n row slots a lane, at least ceil(E / 32)) and rows E..CS - 2 zero:
//    J p (lane = row) reads the lane's rows of one column at compile-time
//    offsets 32 k, p_v by shuffle; J^T f (lane = dof) walks its own column
//    against the row forces in shared memory, in eight partial sums in a
//    fixed order, so runs are deterministic. Both are free of bank
//    conflicts.
//  - J is built once per contact: lane = dof loads its cdof row once; lane
//    l loads contact l's offsets, frame and friction of each 32 contacts,
//    which reach the other lanes by shuffle; the dof masks are loaded a few
//    contacts at a time; each contact's relative Jacobian and frame
//    projections are computed once and give its F facet entries, each
//    with the plain version's expression (`contact_rows`).
//  - Loads from device memory are issued in batches, so that the set-up
//    waits on a few load latencies, not on one per contact or row.
//  - The Euler update stages M + dt*D and its inverse through J's region
//    after the last J^T f. dt is the batch's one timestep or each env's
//    own (the stride over a (B,) tensor: 1), as the reference takes dt
//    per lane.
// The CG loop is cg_common.cuh's `cg_solve`, which kernel F runs too; its
// arithmetic of every row and dof follows the plain version, and only the
// order of the sums differs.

#include "cg_common.cuh"

namespace {

using namespace cg_common;

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
  const float* Mimp;      // with the Euler update only (null without)
  const float* Minv_imp;
  const float* qvel;      // (B, V)
  const float* qfrc_smooth;  // with the Euler update
  const float* qacc_prev;
  const float* qs_in;        // without it: qacc_smooth and the warmstart
  const float* x0;
  const int* kind;        // (E,) row kinds
  const float* dt;        // the timestep: env b's at dt[b * dt_stride]
  float* x;               // (B, V) qacc
  float* f;               // (B, E) efc force
  float* qfrc;            // (B, V) J^T f
  float* qvel_new;        // (B, V), with the Euler update
  float* qs;              // (B, V) qacc_smooth, with the Euler update
  float* trace;           // (B, iterations + 1, trace_floats) or null
  int n_s, S, F, V, iterations;
  int dt_stride;          // 0: one dt for the batch; 1: a (B,) tensor
};

// Rows a lane keeps in registers: all of them, up to 8, for V <= 32.
__host__ __device__ inline int reg_rows(int E, int V) {
  const int nk = (E + 31) / 32;
  if (V <= 32) return nk < 1 ? 1 : nk > 8 ? 8 : nk;
  return V <= 64 ? 8 : 4;
}

// Shared memory of one env, in floats: J's region (J by column, and at
// least 2 V rows of stride Vs where it stages two (V, V) matrices: M and
// M^-1 for V <= 32, and the Euler update's), the two matrices for V > 32,
// the row forces, and the rows past the register rows (5 values each).
struct Layout {
  int Vs, nk, CS, nspill;
  size_t mats, f, spill, total;
};

__host__ __device__ inline Layout layout(int E, int V, bool euler) {
  Layout l;
  l.Vs = row_stride(V);
  l.nk = (E + 31) / 32;
  const int R = reg_rows(E, V);
  l.CS = 32 * (l.nk > R ? l.nk : R) + 1;
  l.nspill = l.nk > R ? l.nk - R : 0;
  const size_t jsize = (size_t)V * l.CS;
  const size_t staged = (euler || V <= 32) ? 2 * (size_t)V * l.Vs : 0;
  l.mats = jsize > staged ? jsize : staged;
  l.f = l.mats + (V > 32 ? 2 * (size_t)V * l.Vs : 0);
  l.f = (l.f + 3) / 4 * 4;  // 16-byte aligned for float4 reads
  l.spill = l.f + (E + 3) / 4 * 4;
  l.total = l.spill + 5 * 32 * (size_t)l.nspill;
  return l;
}

// Facets k and k + 1 of a contact's rows (rows r and r + 1 of column col).
__device__ __forceinline__ void put_pair(float* col, int k, float Jn, float mu, float Jt) {
  col[k] = Jn + mu * Jt;
  col[k + 1] = Jn - mu * Jt;
}

// One contact's offsets, frame (normal | tangent1 | tangent2) and friction.
struct Contact {
  float o1[3], o2[3], fr[9], fc[5];
};

// J by column: the scalar rows, the contact rows (contact-major and
// facet-minor), and zeros in rows E..CS - 2; lane = dof.
template <int DPL>
__device__ __forceinline__ void build_j(const Params& p, float* J, int CS) {
  constexpr int G = DPL < 8 ? 8 / DPL : 1;  // contacts whose dof masks load together
  const int lane = threadIdx.x, b = blockIdx.x;
  const int V = p.V, S = p.S, F = p.F, n_s = p.n_s;
  const int E = n_s + S * F;
  for (int idx = lane; idx < n_s * V; idx += 32) {
    const int i = idx / V;
    J[(idx - i * V) * CS + i] = p.Js[(size_t)b * n_s * V + idx];
  }
  float cd[DPL][6];
#pragma unroll
  for (int q = 0; q < DPL; ++q) {
    const int v = lane + 32 * q;
#pragma unroll
    for (int c = 0; c < 6; ++c) cd[q][c] = v < V ? p.cdof[((size_t)b * V + v) * 6 + c] : 0.0f;
    for (int r = E; r < CS - 1; ++r)
      if (v < V) J[v * CS + r] = 0.0f;
  }
  for (int s0 = 0; s0 < S; s0 += 32) {
    // lane l holds contact s0 + l
    Contact mine;
    {
      const int s = s0 + lane;
      const bool ok = s < S;
      const size_t bs = (size_t)b * S + (ok ? s : 0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        mine.o1[c] = ok ? p.off1[bs * 3 + c] : 0.0f;
        mine.o2[c] = ok ? p.off2[bs * 3 + c] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) mine.fr[c] = ok ? p.frame[bs * 9 + c] : 0.0f;
#pragma unroll
      for (int c = 0; c < 5; ++c) mine.fc[c] = ok ? p.fric[bs * 5 + c] : 0.0f;
    }
    const int n = S - s0 < 32 ? S - s0 : 32;
    for (int g = 0; g < n; g += G) {
      float mm1[G][DPL], mm2[G][DPL];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < DPL; ++q) {
          const int v = lane + 32 * q;
          const bool ok = g + j < n && v < V;
          const size_t at = ((size_t)b * S + s0 + g + j) * V + v;
          mm1[j][q] = ok ? p.m1[at] : 0.0f;
          mm2[j][q] = ok ? p.m2[at] : 0.0f;
        }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (g + j >= n) break;
        const int s = s0 + g + j;
        Contact c;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          c.o1[i] = __shfl_sync(kFull, mine.o1[i], g + j);
          c.o2[i] = __shfl_sync(kFull, mine.o2[i], g + j);
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) c.fr[i] = __shfl_sync(kFull, mine.fr[i], g + j);
#pragma unroll
        for (int i = 0; i < 5; ++i) c.fc[i] = __shfl_sync(kFull, mine.fc[i], g + j);
        const float* o1 = c.o1;
        const float* o2 = c.o2;
        const float* fr = c.fr;
        const float* fc = c.fc;
#pragma unroll
        for (int q = 0; q < DPL; ++q) {
          const int v = lane + 32 * q;
          if (v >= V) continue;
          const float a0 = cd[q][0], a1 = cd[q][1], a2 = cd[q][2];
          const float l0 = cd[q][3], l1 = cd[q][4], l2 = cd[q][5];
          const float m1 = mm1[j][q], m2 = mm2[j][q];
          // jac = (lin + cross(ang, off)) * mask
          const float j10 = (l0 + (a1 * o1[2] - a2 * o1[1])) * m1;
          const float j11 = (l1 + (a2 * o1[0] - a0 * o1[2])) * m1;
          const float j12 = (l2 + (a0 * o1[1] - a1 * o1[0])) * m1;
          const float j20 = (l0 + (a1 * o2[2] - a2 * o2[1])) * m2;
          const float j21 = (l1 + (a2 * o2[0] - a0 * o2[2])) * m2;
          const float j22 = (l2 + (a0 * o2[1] - a1 * o2[0])) * m2;
          const float r0 = j20 - j10, r1 = j21 - j11, r2 = j22 - j12;
          const float Jn = (fr[0] * r0 + fr[1] * r1) + fr[2] * r2;
          float* col = J + v * CS + n_s + s * F;
          if (F == 1) {
            col[0] = Jn;
            continue;
          }
          const float Jt1 = (fr[3] * r0 + fr[4] * r1) + fr[5] * r2;
          const float Jt2 = (fr[6] * r0 + fr[7] * r1) + fr[8] * r2;
          put_pair(col, 0, Jn, fc[0], Jt1);
          put_pair(col, 2, Jn, fc[1], Jt2);
          if (F < 6) continue;
          // torsional and rolling rows: ang * (m2 - m1)
          const float dm = m2 - m1;
          const float q0 = a0 * dm, q1 = a1 * dm, q2 = a2 * dm;
          put_pair(col, 4, Jn, fc[2], (fr[0] * q0 + fr[1] * q1) + fr[2] * q2);
          if (F < 10) continue;
          put_pair(col, 6, Jn, fc[3], (fr[3] * q0 + fr[4] * q1) + fr[5] * q2);
          put_pair(col, 8, Jn, fc[4], (fr[6] * q0 + fr[7] * q1) + fr[8] * q2);
        }
      }
    }
  }
}

template <int DPL, int R>
__global__ void __launch_bounds__(32) cg_full_kernel(Params p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int V = p.V, n_s = p.n_s;
  const int E = n_s + p.S * p.F;
  const bool euler = p.Mimp != nullptr;
  const Layout L = layout(E, V, euler);
  const int Vs = L.Vs, nk = L.nk, CS = L.CS;
  float* J = sm;
  float* fs = sm + L.f;
  const int ns = 32 * L.nspill;
  float* sp0 = sm + L.spill;
  ColSys<DPL, R, KindW<R>, Spill> sys{
      J, CS, V, E, nk, fs, {},
      Spill{sp0, sp0 + ns, sp0 + 2 * ns, sp0 + 3 * ns, reinterpret_cast<int*>(sp0 + 4 * ns)}};
  Rows<R, KindW<R>>& rs = sys.rs;
  const Spill& sp = sys.sp;
  const size_t bVV = (size_t)b * V * V, bV = (size_t)b * V, bE = (size_t)b * E;

  // M and M^-1: rows into registers through J's region (V <= 32), or into
  // their own region
  float* staged = DPL == 1 ? J : sm + L.mats;
  stage_pair(staged, p.M + bVV, p.Minv + bVV, V, Vs);
  __syncwarp();
  Mat<DPL> M, Minv;
  M.load(staged, V, Vs);
  Minv.load(staged + V * Vs, V, Vs);
  __syncwarp();

  float x[DPL], qs[DPL], qv[DPL];
  load_vec(p.qvel + bV, qv, V);
  if (euler) {
    // qacc_smooth = M^-1 qfrc_smooth; warmstart from qacc_prev when finite
    float qf[DPL], prev[DPL];
    load_vec(p.qfrc_smooth + bV, qf, V);
    load_vec(p.qacc_prev + bV, prev, V);
    Minv.apply(qf, qs, V, Vs);
    store_vec(p.qs + bV, qs, V);
    bool bad = false;
#pragma unroll
    for (int q = 0; q < DPL; ++q) bad |= !(fabsf(prev[q]) < 1e10f);
    const bool finite = !__any_sync(kFull, bad);
#pragma unroll
    for (int q = 0; q < DPL; ++q) x[q] = finite ? prev[q] : qs[q];
  } else {
    load_vec(p.qs_in + bV, qs, V);
    load_vec(p.x0 + bV, x, V);
  }

  build_j<DPL>(p, J, CS);
  __syncwarp();

  // row weights; jar = J x0 - aref, aref = -bref * J qvel - kimp * pos
  rs.w.kinds = 0;
  j_times<DPL, R>(J, CS, V, nk, qv, rs.Jp, sp.Jp);
  j_times<DPL, R>(J, CS, V, nk, x, rs.jar, sp.jar);
  auto init = [&](int k, float& jar, float jqv, float& D, float& fl, int& kd) {
    const int r = lane + 32 * k;
    const bool ok = r < E;
    const size_t at = bE + (ok ? r : 0);
    const int kr = ok ? p.kind[r] : kOneSided;
    const float act = ok ? p.active[at] : 0.0f, rc = ok ? p.rcoef[at] : 1.0f;
    const float flr = ok ? p.floss[at] : 0.0f, br = ok ? p.bref[at] : 0.0f;
    const float ki = ok ? p.kimp[at] : 0.0f, ps = ok ? p.pos[at] : 0.0f;
    D = act > 0.0f ? 1.0f / rc : 0.0f;
    fl = flr;
    kd = kr;
    const float aref = -br * jqv - ki * ps;
    jar = ok ? jar - aref : 0.0f;
  };
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int kd;
    init(k, rs.jar[k], rs.Jp[k], rs.w.D[k], rs.w.fl[k], kd);
    rs.w.kinds |= (kd & 3) << (2 * k);
  }
  for (int k = R; k < nk; ++k) {
    const int i = (k - R) * 32 + lane;
    init(k, sp.jar[i], sp.Jp[i], sp.D[i], sp.fl[i], sp.kind[i]);
  }

  // the solve; f = -force(jar), qfrc = J^T f
  float* tr = p.trace ? p.trace + (size_t)b * (p.iterations + 1) * trace_floats(V, E) : nullptr;
  cg_solve<DPL>(sys, M, Minv, x, qs, p.f + bE, V, Vs, p.iterations, tr);
  float t[DPL];
  store_vec(p.x + bV, x, V);
  __syncwarp();
  jt_times<DPL>(J, fs, E, V, CS, 1, t);
  store_vec(p.qfrc + bV, t, V);

  if (euler) {
    // implicit-damping Euler: qacc = Mimp^-1 M x with one refinement step,
    // M + dt*D and its inverse staged into J's region
    __syncwarp();
    stage_pair(J, p.Mimp + bVV, p.Minv_imp + bVV, V, Vs);
    __syncwarp();
    const float* Mimp = J;
    const float* Minvimp = J + V * Vs;
    float Mp[DPL], Mg[DPL], dx[DPL];
    M.apply(x, Mp, V, Vs);
    smem_matvec<DPL>(Minvimp, Mp, Mg, V, Vs);
    smem_matvec<DPL>(Mimp, Mg, t, V, Vs);
#pragma unroll
    for (int q = 0; q < DPL; ++q) dx[q] = Mp[q] - t[q];
    smem_matvec<DPL>(Minvimp, dx, t, V, Vs);
    const float dt = p.dt[(size_t)b * p.dt_stride];
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const float qacc_imp = Mg[q] + t[q];
      t[q] = qv[q] + dt * qacc_imp;
    }
    store_vec(p.qvel_new + bV, t, V);
  }
}

using KernelFn = void (*)(Params);

KernelFn pick(int E, int V) {
  if (V <= 32) {
    switch (reg_rows(E, V)) {
      case 1: return cg_full_kernel<1, 1>;
      case 2: return cg_full_kernel<1, 2>;
      case 3: return cg_full_kernel<1, 3>;
      case 4: return cg_full_kernel<1, 4>;
      case 5: return cg_full_kernel<1, 5>;
      case 6: return cg_full_kernel<1, 6>;
      case 7: return cg_full_kernel<1, 7>;
      default: return cg_full_kernel<1, 8>;
    }
  }
  if (V <= 64) return cg_full_kernel<2, 8>;
  if (V <= 128) return cg_full_kernel<4, 4>;
  return cg_full_kernel<8, 4>;
}

// The kernel for E rows and V dofs with its dynamic shared memory set, in
// `smem` bytes; cudaErrorInvalidValue when V is out of range or the env's
// arrays do not fit in one block's shared memory.
cudaError_t configure(int E, int V, bool euler, KernelFn* fn, size_t* smem) {
  if (V < 1 || V > kMaxV || E < 0) return cudaErrorInvalidValue;
  *fn = pick(E, V);
  *smem = layout(E, V, euler).total * sizeof(float);
  if (*smem > cg_common::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)*smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

int launch(const Params& p, int B, cudaStream_t stream) {
  if (p.S < 0 || p.n_s < 0) return (int)cudaErrorInvalidValue;
  KernelFn fn;
  size_t smem;
  const cudaError_t e = configure(p.n_s + p.S * p.F, p.V, p.Mimp != nullptr, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<B, 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one env (one block) of kernel B for E rows and
// V dofs, with the Euler update or without.
extern "C" long long robogym_cg_full_smem_bytes(int E, int V, int euler) {
  return (long long)(layout(E, V, euler != 0).total * sizeof(float));
}

// Envs (blocks) of kernel B resident on one SM for E rows and V dofs, with
// the Euler update or without; a negative CUDA error code on failure.
extern "C" int robogym_cg_full_blocks_per_sm(int E, int V, int euler) {
  KernelFn fn;
  size_t smem;
  cudaError_t e = configure(E, V, euler != 0, &fn, &smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, 32, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// Both entry points return cudaErrorInvalidValue, and launch nothing, when
// V > 256 or the env's arrays do not fit in one block's shared memory. A
// non-null `trace` (B, iterations + 1, robogym_cg_trace_floats(V, E)) gets
// each env's solve state after the set-up and after every iteration.
extern "C" long long robogym_cg_trace_floats(int V, int E) { return trace_floats(V, E); }

extern "C" int robogym_cg_full(
    const float* Js, const float* off1, const float* off2, const float* frame, const float* fric,
    const float* m1, const float* m2, const float* cdof, const float* pos, const float* kimp,
    const float* bref, const float* rcoef, const float* active, const float* floss,
    const float* M, const float* Minv, const float* Mimp, const float* Minv_imp,
    const float* qvel, const float* qfrc_smooth, const float* qacc_prev, const int* kind,
    const float* dt, float* x, float* f, float* qfrc, float* qvel_new, float* qs, float* trace,
    int B, int n_s, int S, int F, int V, int iterations, int dt_stride, cudaStream_t stream) {
  if (Mimp == nullptr || (dt_stride != 0 && dt_stride != 1)) return (int)cudaErrorInvalidValue;
  Params p{Js, off1, off2, frame, fric, m1, m2, cdof, pos, kimp, bref, rcoef, active, floss,
           M, Minv, Mimp, Minv_imp, qvel, qfrc_smooth, qacc_prev, nullptr, nullptr, kind, dt,
           x, f, qfrc, qvel_new, qs, trace, n_s, S, F, V, iterations, dt_stride};
  return launch(p, B, stream);
}

extern "C" int robogym_cg_full_noeuler(
    const float* Js, const float* off1, const float* off2, const float* frame, const float* fric,
    const float* m1, const float* m2, const float* cdof, const float* pos, const float* kimp,
    const float* bref, const float* rcoef, const float* active, const float* floss,
    const float* M, const float* Minv, const float* qvel, const float* qs, const float* x0,
    const int* kind, float* x, float* f, float* qfrc, float* trace,
    int B, int n_s, int S, int F, int V, int iterations, cudaStream_t stream) {
  Params p{Js, off1, off2, frame, fric, m1, m2, cdof, pos, kimp, bref, rcoef, active, floss,
           M, Minv, nullptr, nullptr, qvel, nullptr, nullptr, qs, x0, kind, nullptr,
           x, f, qfrc, nullptr, nullptr, trace, n_s, S, F, V, iterations, 0};
  return launch(p, B, stream);
}
