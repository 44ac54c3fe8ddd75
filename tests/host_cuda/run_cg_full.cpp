// Runs kernel B on the host, block after block, each block as 32 threads
// (`host_launch` of cuda_runtime.h here). `cg_full_host.cpp` is cg_full.cu
// with its launch and its `extern __shared__` line taken out, written by
// the test.
//
//   run_cg_full IN OUT
//
// IN: 8 int32 (B, n_s, S, F, V, iterations, euler, trace), then the 24 float
// arrays of the kernel's Params up to dt, each an int64 count and its
// float32 values (count 0 for a null pointer; dt: 1 value for the batch,
// or B, one an env), then the row kinds (int64 count, int32 values).
// OUT: x, f, qfrc, qvel_new, qs as float32, and with trace 1 the trace
// (B, iterations + 1, trace_floats(V, E)), NaN where the kernel wrote
// nothing.
#include <cstdint>
#include <cstdio>
#include <vector>

extern float sm[];
#include "cg_full_host.cpp"

thread_local uint3 threadIdx, blockIdx;
float sm[1 << 16];

static std::vector<float> read_floats(FILE* f) {
  int64_t n = 0;
  if (fread(&n, 8, 1, f) != 1) return {};
  std::vector<float> v(n);
  if (n && fread(v.data(), 4, n, f) != (size_t)n) v.clear();
  return v;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int h[8];
  if (fread(h, 4, 8, f) != 8) return 2;
  const int B = h[0], n_s = h[1], S = h[2], F = h[3], V = h[4], its = h[5], euler = h[6];
  const int traced = h[7];
  std::vector<std::vector<float>> a;
  for (int i = 0; i < 24; ++i) a.push_back(read_floats(f));
  int64_t nk = 0;
  if (fread(&nk, 8, 1, f) != 1) return 2;
  std::vector<int> kind(nk);
  if (nk && fread(kind.data(), 4, nk, f) != (size_t)nk) return 2;
  fclose(f);
  const int E = n_s + S * F;
  std::vector<float> x(B * V), fo(B * E), qfrc(B * V), qvn(B * V), qs(B * V);
  std::vector<float> tr(traced ? (size_t)B * (its + 1) * cg_common::trace_floats(V, E) : 0,
                        std::nanf(""));
  auto P = [&](int i) -> const float* { return a[i].empty() ? nullptr : a[i].data(); };
  Params p{P(0),  P(1),  P(2),  P(3),  P(4),  P(5),  P(6),  P(7),  P(8),  P(9),  P(10), P(11),
           P(12), P(13), P(14), P(15), P(16), P(17), P(18), P(19), P(20), P(21), P(22),
           kind.data(), P(23), x.data(), fo.data(), qfrc.data(), qvn.data(), qs.data(),
           traced ? tr.data() : nullptr, n_s, S, F, V, its, a[23].size() > 1 ? 1 : 0};
  KernelFn fn;
  size_t smem;
  if (configure(E, V, euler != 0, &fn, &smem) != cudaSuccess || smem > sizeof(sm)) return 3;
  for (size_t i = 0; i < smem / 4; ++i) sm[i] = std::nanf("");  // no read before a write
  host_launch(fn, B, 32, smem, nullptr, p);
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  for (const auto* v : {&x, &fo, &qfrc, &qvn, &qs, &tr}) fwrite(v->data(), 4, v->size(), o);
  fclose(o);
  return 0;
}
