// __half as GCC's _Float16, for tests/cuda_emulation/cuda_runtime.h.
#pragma once

struct __half {
  _Float16 x;
};
inline float __half2float(__half h) { return static_cast<float>(h.x); }
inline __half __float2half_rn(float f) { return __half{static_cast<_Float16>(f)}; }
