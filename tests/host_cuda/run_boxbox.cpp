// Runs the box-box kernel on the host through its C entry point, each
// launch block after block and warp after warp (cuda_runtime.h here).
// `boxbox_host.cpp` is boxbox.cu with its `<<<...>>>` launch turned into a
// call of `host_launch`, written by the test.
//
//   run_boxbox IN OUT
//
// IN: one int32 (the pair count), then the six operands xp1, xm1, s1, xp2,
// xm2, s2, each an int64 count and its float32 values. OUT: dist, pos and
// the normal as float32. Exits 3 on a CUDA error, 4 where the kernel wrote
// past the last pair.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>
#include "boxbox_host.cpp"

thread_local uint3 threadIdx, blockIdx;

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
  int n_pairs = 0;
  if (fread(&n_pairs, 4, 1, f) != 1) return 2;
  std::vector<std::vector<float>> a;
  for (int i = 0; i < 6; ++i) a.push_back(read_floats(f));
  fclose(f);
  // each output with room for one block's pairs past the last, which must
  // stay NaN: a group past the last pair writes nothing
  std::vector<std::vector<float>> out;
  for (int width : {kCand, 3 * kCand, 3}) {
    out.emplace_back((size_t)(n_pairs + kPairsPerBlock) * width, std::nanf(""));
  }
  const int rc = robogym_boxbox(a[0].data(), a[1].data(), a[2].data(), a[3].data(), a[4].data(),
                                a[5].data(), out[0].data(), out[1].data(), out[2].data(), n_pairs,
                                nullptr);
  if (rc) return 3;
  for (const auto& v : out) {
    const size_t n = v.size() / (n_pairs + kPairsPerBlock) * n_pairs;
    for (size_t i = n; i < v.size(); ++i) {
      if (!std::isnan(v[i])) return 4;
    }
  }
  FILE* w = fopen(argv[2], "wb");
  if (!w) return 2;
  for (const auto& v : out) fwrite(v.data(), 4, v.size() / (n_pairs + kPairsPerBlock) * n_pairs, w);
  fclose(w);
  return 0;
}
