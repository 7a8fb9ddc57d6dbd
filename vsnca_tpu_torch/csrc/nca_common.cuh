// Pieces shared by the DyNCA kernels (nca_step.cu, nca_train.cu): the tile
// geometry, the size limits, the update-mask hash, bf16 rounding, the
// padding rule and the perception stencils. Every kernel that includes this
// draws the same masks and rounds the same way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NCA_TILE 16
#define NCA_HALO (NCA_TILE + 2)
#define NCA_C_MAX 16
#define NCA_CC_MAX 4
#define NCA_F_MAX 128

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Mask stream key: the batch index enters as prng_seed(seed + bidx)
// (pallas_step.py:1439), the step as in _step_seed (pallas_train.py:82).
__device__ __forceinline__ uint32_t mask_bits(uint32_t seed, uint32_t b,
                                              uint32_t step, uint32_t pix) {
  uint32_t key = seed + b + step * 7919u;
  return fmix32(fmix32(key) ^ pix);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Index of a halo row/column under the padding mode; -1 means "zero".
__device__ __forceinline__ int pad_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == 0) return ((i % n) + n) % n;  // circular
  if (mode == 1) return i < 0 ? 0 : n - 1;  // replicate
  return -1;                                // zeros
}

// The JAX stencil's term order (perception.py::stencil_3x3), with products
// and sums kept unfused so the float32 percept rounds as the reference's.
// t points at the top-left tap of a 3x3 window in a row-major tile whose
// rows are NCA_HALO floats apart.
__device__ __forceinline__ void stencils(const float* t, float& sx, float& sy,
                                         float& lap) {
  const float v00 = t[0], v01 = t[1], v02 = t[2];
  const float v10 = t[NCA_HALO], v11 = t[NCA_HALO + 1], v12 = t[NCA_HALO + 2];
  const float v20 = t[2 * NCA_HALO], v21 = t[2 * NCA_HALO + 1],
              v22 = t[2 * NCA_HALO + 2];
  // SOBEL_X = [[-1,0,1],[-2,0,2],[-1,0,1]]
  float a = __fmul_rn(v00, -1.f);
  a = __fadd_rn(a, v02);
  a = __fadd_rn(a, __fmul_rn(v10, -2.f));
  a = __fadd_rn(a, __fmul_rn(v12, 2.f));
  a = __fadd_rn(a, __fmul_rn(v20, -1.f));
  sx = __fadd_rn(a, v22);
  // SOBEL_Y = [[-1,-2,-1],[0,0,0],[1,2,1]]
  a = __fmul_rn(v00, -1.f);
  a = __fadd_rn(a, __fmul_rn(v01, -2.f));
  a = __fadd_rn(a, __fmul_rn(v02, -1.f));
  a = __fadd_rn(a, v20);
  a = __fadd_rn(a, __fmul_rn(v21, 2.f));
  sy = __fadd_rn(a, v22);
  // LAPLACIAN = [[1,2,1],[2,-12,2],[1,2,1]]
  a = v00;
  a = __fadd_rn(a, __fmul_rn(v01, 2.f));
  a = __fadd_rn(a, v02);
  a = __fadd_rn(a, __fmul_rn(v10, 2.f));
  a = __fadd_rn(a, __fmul_rn(v11, -12.f));
  a = __fadd_rn(a, __fmul_rn(v12, 2.f));
  a = __fadd_rn(a, v20);
  a = __fadd_rn(a, __fmul_rn(v21, 2.f));
  lap = __fadd_rn(a, v22);
}
