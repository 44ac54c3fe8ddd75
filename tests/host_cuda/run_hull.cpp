// Runs the hull kernels on the host through their C entry points, each
// launch block after block and warp after warp (cuda_runtime.h here).
// `hull_host.cpp` is hull_sweep.cu with each `<<<...>>>` launch turned into
// a call of `host_launch` and its `extern __shared__` lines taken out,
// written by the test.
//
//   run_hull IN OUT
//
// IN: 6 int32 (entry: 0 hull_manifold, 1 hull_manifold_world, 2 hull_pair,
// 3 hull_pair_world; BK, V1, V2, DXp, DX), then the entry's float operands
// in its order up to xd (9 local, 5 world) and the direction table, each an
// int64 count and its float32 values. OUT: the outputs as float32 in the
// entry's order (manifold: dist4, pos4, n; pair: dist, pos, n, p2). Exits
// 3 on a CUDA error, 4 where a kernel wrote past the last pair.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>
extern float4 cvs[];
#include "hull_host.cpp"

thread_local uint3 threadIdx, blockIdx;
float4 cvs[kPairsPerBlock * (2 * kMaxVerts + 1)];

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
  const int entry = h[0], BK = h[1], V1 = h[2], V2 = h[3], DXp = h[4], DX = h[5];
  const bool world = entry & 1, manifold = entry < 2;
  std::vector<std::vector<float>> a;
  for (int i = 0; i < (world ? 5 : 9) + 1; ++i) a.push_back(read_floats(f));
  fclose(f);
  // each output with room for one block's pairs past the last, which must
  // stay NaN: a group past the last pair writes nothing
  std::vector<std::vector<float>> out;
  for (int width : manifold ? std::vector<int>{4, 12, 3} : std::vector<int>{1, 3, 3, 3}) {
    out.emplace_back((size_t)(BK + kPairsPerBlock) * width, std::nanf(""));
  }
  auto p = [&](int i) { return a[i].data(); };
  auto o = [&](int i) { return out[i].data(); };
  int rc;
  if (entry == 0) {
    rc = robogym_hull_manifold(p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), o(0),
                               o(1), o(2), BK, V1, V2, DXp, DX, nullptr);
  } else if (entry == 1) {
    rc = robogym_hull_manifold_world(p(0), p(1), p(2), p(3), p(4), p(5), o(0), o(1), o(2), BK,
                                     V1, V2, DXp, DX, nullptr);
  } else if (entry == 2) {
    rc = robogym_hull_pair(p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), o(0),
                           o(1), o(2), o(3), BK, V1, V2, DXp, DX, nullptr);
  } else {
    rc = robogym_hull_pair_world(p(0), p(1), p(2), p(3), p(4), p(5), o(0), o(1), o(2), o(3), BK,
                                 V1, V2, DXp, DX, nullptr);
  }
  if (rc) return 3;
  for (const auto& v : out) {
    const size_t n = v.size() / (BK + kPairsPerBlock) * BK;
    for (size_t i = n; i < v.size(); ++i) {
      if (!std::isnan(v[i])) return 4;
    }
  }
  FILE* w = fopen(argv[2], "wb");
  if (!w) return 2;
  for (const auto& v : out) fwrite(v.data(), 4, v.size() / (BK + kPairsPerBlock) * BK, w);
  fclose(w);
  return 0;
}
