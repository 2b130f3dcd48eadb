// The maximum that keeps a NaN, as torch.maximum and jnp.maximum do (fmaxf
// drops one), so a NaN score gives its query row m = NaN.  The attention
// kernels' running maxima (bf16_attention.cu, int4_attention.cuh).

#pragma once

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
