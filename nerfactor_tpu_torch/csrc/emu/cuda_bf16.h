#pragma once
// CPU emulation of the bf16 type the kernels use (see cuda_runtime.h):
// round-to-nearest-even conversion from float, as __float2bfloat16.
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t x; };

inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short v) { return {v}; }
