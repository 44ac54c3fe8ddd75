// Runs kernel A on the host through its C entry point, block after block,
// each block's threads all at once (cuda_runtime.h here). `spd_host.cpp` is
// spd_inverse.cu with its `<<<...>>>` launch turned into a call of
// `host_launch` and its `extern __shared__` line taken out, written by the
// test.
//
//   run_spd IN OUT
//
// IN: 3 int32 (B, V, dev), then B*V*V float32. OUT: the B inverses as
// float32, through `robogym_spd_inverse`, or with dev = 1 through
// `robogym_spd_inverse_dev` (the block kernel in device memory at any V).
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>
extern float4 smem[];
#include "spd_host.cpp"

thread_local uint3 threadIdx, blockIdx;
// the largest block: two warps at Vp = 64, or the block kernel in shared
// memory at kMaxSmemV = 240 dofs
float4 smem[(smem_bytes(64) > smem_bytes(kMaxSmemV) ? smem_bytes(64) : smem_bytes(kMaxSmemV)) / 16];

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int h[3];
  if (fread(h, 4, 3, f) != 3) return 2;
  const size_t n = (size_t)h[0] * h[1] * h[1];
  std::vector<float> A(n), out(n, std::nanf(""));
  if (fread(A.data(), 4, n, f) != n) return 2;
  fclose(f);
  for (auto& v : smem) v = make_float4(std::nanf(""), std::nanf(""), std::nanf(""), std::nanf(""));
  const auto entry = h[2] ? robogym_spd_inverse_dev : robogym_spd_inverse;
  if (entry(A.data(), out.data(), h[0], h[1], nullptr) != 0) return 3;
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  fwrite(out.data(), 4, n, o);
  fclose(o);
  return 0;
}
