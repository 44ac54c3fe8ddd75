// A host stand-in for the bfloat16 conversions of <cuda_bf16.h>: float32
// to bfloat16 rounds to nearest, ties to even, as the card's cvt.rn.bf16
// and PyTorch's conversion do.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40u)};  // quiet NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
