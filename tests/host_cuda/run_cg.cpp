// Runs kernel F on the host, block after block, each block as 32 threads
// (`host_launch` of cuda_runtime.h here). `cg_host.cpp` is cg.cu with its
// launch and its `extern __shared__` line taken out, written by the test.
//
//   run_cg IN OUT
//
// IN: 6 int32 (B, E, V, iterations, route: 0 J in shared memory, 1 J in
// device memory, trace: 0 or 1), then the 10 float arrays of the kernel's
// Params up to x0, each an int64 count and its float32 values. OUT: x, f
// as float32, and with trace 1 the trace (B, iterations + 1,
// trace_floats(V, E)), NaN where the kernel wrote nothing.
#include <cstdint>
#include <cstdio>
#include <vector>

extern float sm[];
#include "cg_host.cpp"

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
  int h[6];
  if (fread(h, 4, 6, f) != 6) return 2;
  const int B = h[0], E = h[1], V = h[2], its = h[3], dev = h[4], traced = h[5];
  std::vector<std::vector<float>> a;
  for (int i = 0; i < 10; ++i) a.push_back(read_floats(f));
  fclose(f);
  Plan pl;
  if (configure(E, V, dev != 0, &pl) != cudaSuccess || pl.smem > sizeof(sm)) return 3;
  if (!dev && device_route(E, V)) return 3;
  std::vector<float> x(B * V), fo(B * E), scratch(B * pl.scratch + 4, std::nanf(""));
  std::vector<float> tr(traced ? (size_t)B * (its + 1) * cg_common::trace_floats(V, E) : 0,
                        std::nanf(""));
  Params p{a[0].data(), a[1].data(), a[2].data(), a[3].data(), a[4].data(), a[5].data(),
           a[6].data(), a[7].data(), a[8].data(), a[9].data(), x.data(), fo.data(),
           scratch.data(), traced ? tr.data() : nullptr, E, V, its};
  for (size_t i = 0; i < pl.smem / 4; ++i) sm[i] = std::nanf("");  // no read before a write
  host_launch(pl.fn, B, 32, pl.smem, nullptr, p);
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  for (const auto* v : {&x, &fo, &tr}) fwrite(v->data(), 4, v->size(), o);
  fclose(o);
  return 0;
}
