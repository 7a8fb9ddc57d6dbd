// Pieces shared by the DyNCA kernels (nca_step.cu, nca_train.cu): the tile
// geometry, the size limits, the update-mask hash, bf16 rounding and the
// state's storage types, the padding rule, the perception stencils and the
// multiscale (scales (0, 1)) percept. Every kernel that includes this draws
// the same masks, rounds the same way and forms the same percept bit for
// bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NCA_TILE 16
#define NCA_HALO (NCA_TILE + 2)
#define NCA_C_MAX 16
#define NCA_CC_MAX 4
#define NCA_F_MAX 128

// Multiscale geometry of a 16 x 16 block: its pixels read the upsampled
// half-resolution percept on a 10 x 10 footprint of half pixels (the 8 x 8
// half pixels under the block plus one each side, for the 0.25 taps), and
// that percept's 3x3 stencils read a 12 x 12 tile of the half state.
#define NCA_HFOOT (NCA_TILE / 2 + 2)
#define NCA_HHALO (NCA_HFOOT + 2)

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

// The state's storage types: float32, or bfloat16 (the bf16-state form of
// nca_step), read into float32 registers and rounded (to nearest even) on
// store.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Index of a halo row/column under the padding mode; -1 means "zero".
__device__ __forceinline__ int pad_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == 0) return ((i % n) + n) % n;  // circular
  if (mode == 1) return i < 0 ? 0 : n - 1;  // replicate
  return -1;                                // zeros
}

// One stencil operation's result: float32, or with RND rounded to bf16, as
// JAX computes a stencil on a bf16 state (every product and every partial
// sum a bf16 value; pallas_step.py::_make_kernel's padded bf16 scratch).
template <bool RND>
__device__ __forceinline__ float st_round(float v) {
  return RND ? bf16_round(v) : v;
}

// The JAX stencil's term order (perception.py::stencil_3x3), with products
// and sums kept unfused so the float32 percept rounds as the reference's
// (with RND, each product and sum rounded to bf16). t points at the
// top-left tap of a 3x3 window in a row-major tile whose rows are LD floats
// apart.
template <int LD = NCA_HALO, bool RND = false>
__device__ __forceinline__ void stencils(const float* t, float& sx, float& sy,
                                         float& lap) {
  const float v00 = t[0], v01 = t[1], v02 = t[2];
  const float v10 = t[LD], v11 = t[LD + 1], v12 = t[LD + 2];
  const float v20 = t[2 * LD], v21 = t[2 * LD + 1], v22 = t[2 * LD + 2];
#define NCA_MUL(a, b) st_round<RND>(__fmul_rn(a, b))
#define NCA_ADD(a, b) st_round<RND>(__fadd_rn(a, b))
  // SOBEL_X = [[-1,0,1],[-2,0,2],[-1,0,1]]
  float a = NCA_MUL(v00, -1.f);
  a = NCA_ADD(a, v02);
  a = NCA_ADD(a, NCA_MUL(v10, -2.f));
  a = NCA_ADD(a, NCA_MUL(v12, 2.f));
  a = NCA_ADD(a, NCA_MUL(v20, -1.f));
  sx = NCA_ADD(a, v22);
  // SOBEL_Y = [[-1,-2,-1],[0,0,0],[1,2,1]]
  a = NCA_MUL(v00, -1.f);
  a = NCA_ADD(a, NCA_MUL(v01, -2.f));
  a = NCA_ADD(a, NCA_MUL(v02, -1.f));
  a = NCA_ADD(a, v20);
  a = NCA_ADD(a, NCA_MUL(v21, 2.f));
  sy = NCA_ADD(a, v22);
  // LAPLACIAN = [[1,2,1],[2,-12,2],[1,2,1]]
  a = v00;
  a = NCA_ADD(a, NCA_MUL(v01, 2.f));
  a = NCA_ADD(a, v02);
  a = NCA_ADD(a, NCA_MUL(v10, 2.f));
  a = NCA_ADD(a, NCA_MUL(v11, -12.f));
  a = NCA_ADD(a, NCA_MUL(v12, 2.f));
  a = NCA_ADD(a, v20);
  a = NCA_ADD(a, NCA_MUL(v21, 2.f));
  lap = NCA_ADD(a, v22);
#undef NCA_MUL
#undef NCA_ADD
}

// The C x 18 x 18 state tile of the block whose top-left halo pixel is
// (y0, x0), halo resolved by the padding mode, in float32 whatever the
// state's storage type T. All threads of the block call it; the caller
// synchronises.
template <typename T>
__device__ __forceinline__ void stage_tile(float* tile, const T* xb, int C,
                                           int H, int W, int y0, int x0,
                                           int pad_mode, int tid, int nthr) {
  const int HW = H * W;
  for (int i = tid; i < C * NCA_HALO * NCA_HALO; i += nthr) {
    const int c = i / (NCA_HALO * NCA_HALO);
    const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
    const int gy = pad_index(y0 + r, H, pad_mode);
    const int gx = pad_index(x0 + q, W, pad_mode);
    tile[i] = (gy < 0 || gx < 0) ? 0.f
                                 : to_float(xb[(size_t)c * HW + gy * W + gx]);
  }
}

// A 4-byte asynchronous copy from device to shared memory (cp.async): the
// issuing thread does not wait for the value, so a block's staging loop puts
// all its loads in flight at once. cp_async_wait_all waits for every copy
// the thread issued; a __syncthreads after it publishes them to the block.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A 16-byte asynchronous copy (both addresses 16-byte aligned; cached in L2
// only, as the block's own shared memory keeps what it reuses), and the
// groups a double-buffered loop waits on: cp_async_commit closes the copies
// the thread issued since the last commit into a group; cp_async_wait_group<N>
// waits until at most N of the thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage_tile for a float32 state by asynchronous copies (zeros outside the
// grid are plain stores): the caller waits (cp_async_wait_all) and
// synchronises before reading the tile.
__device__ __forceinline__ void stage_tile_async(float* tile, const float* xb, int C,
                                                 int H, int W, int y0, int x0,
                                                 int pad_mode, int tid, int nthr) {
  const int HW = H * W;
  for (int i = tid; i < C * NCA_HALO * NCA_HALO; i += nthr) {
    const int c = i / (NCA_HALO * NCA_HALO);
    const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
    const int gy = pad_index(y0 + r, H, pad_mode);
    const int gx = pad_index(x0 + q, W, pad_mode);
    if (gy < 0 || gx < 0)
      tile[i] = 0.f;
    else
      cp_async4(tile + i, xb + (size_t)c * HW + gy * W + gx);
  }
}

// perception_scales (0, 1), first part: the block's half-resolution
// percept hp [4C][10][10] (blocks raw, sobel_x, sobel_y, laplacian; entry
// (r, q) is half pixel (by*8 - 1 + r, bx*8 - 1 + q)) from a 12 x 12 tile
// of the half state, each half pixel the exact 2x2 mean of the state,
// ((x00 + x01) + x10) + x11 times 0.25 (fused_step.py::half_state), the
// tile's halo resolved at half resolution under the padding mode. Even H
// and W. htile [C][12][12] is scratch. All threads of the block call it;
// it synchronises between its two passes and at its end.
__device__ __forceinline__ void half_percept(float* htile, float* hp,
                                             const float* xb, int C, int H,
                                             int W, int by, int bx,
                                             int pad_mode, int tid, int nthr) {
  const int HW = H * W, H2 = H / 2, W2 = W / 2;
  const int hy0 = by * (NCA_TILE / 2) - 2, hx0 = bx * (NCA_TILE / 2) - 2;
  for (int i = tid; i < C * NCA_HHALO * NCA_HHALO; i += nthr) {
    const int c = i / (NCA_HHALO * NCA_HHALO);
    const int r = (i / NCA_HHALO) % NCA_HHALO, q = i % NCA_HHALO;
    const int gy = pad_index(hy0 + r, H2, pad_mode);
    const int gx = pad_index(hx0 + q, W2, pad_mode);
    float v = 0.f;
    if (gy >= 0 && gx >= 0) {
      const float* p = xb + (size_t)c * HW + (2 * gy) * W + 2 * gx;
      v = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[W]), p[W + 1]),
                    0.25f);
    }
    htile[i] = v;
  }
  __syncthreads();
  const int nf = NCA_HFOOT * NCA_HFOOT;
  for (int i = tid; i < C * nf; i += nthr) {
    const int c = i / nf, r = (i / NCA_HFOOT) % NCA_HFOOT, q = i % NCA_HFOOT;
    const float* t = htile + (c * NCA_HHALO + r) * NCA_HHALO + q;
    float sx, sy, lap;
    stencils<NCA_HHALO>(t, sx, sy, lap);
    const int o = r * NCA_HFOOT + q;
    hp[(0 * C + c) * nf + o] = t[NCA_HHALO + 1];
    hp[(1 * C + c) * nf + o] = sx;
    hp[(2 * C + c) * nf + o] = sy;
    hp[(3 * C + c) * nf + o] = lap;
  }
  __syncthreads();
}

// Footprint indices of the upsample for local pixel p (0..15) of a block
// along one axis of n full pixels: f is the half pixel under it, fn the
// neighbour its 0.25 tap reads — the one before for an even pixel, after
// for an odd one, itself at the edges (the clamp of resize_matrix(2m, m)).
__device__ __forceinline__ void upsample_taps(int block, int p, int n, int& f,
                                              int& fn) {
  const int g = block * NCA_TILE + p, i = g >> 1;
  f = (p >> 1) + 1;
  if ((g & 1) == 0) {
    fn = i == 0 ? f : f - 1;
  } else {
    fn = i == n / 2 - 1 ? f : f + 1;
  }
}

// perception_scales (0, 1), second part: a pixel's averaged percept value
// from its scale-0 value p0 and one [10][10] block s of hp: the upsample
// over W (0.75 s[j] + 0.25 s[jn]) on the half rows i and in, then over H,
// then (p0 + p1) * 0.5 (fused_step.py::multiscale_percept's order).
__device__ __forceinline__ float ms_average(const float* s, int fi, int fin,
                                            int fj, int fjn, float p0) {
  const float ua = __fadd_rn(__fmul_rn(s[fi * NCA_HFOOT + fj], 0.75f),
                             __fmul_rn(s[fi * NCA_HFOOT + fjn], 0.25f));
  const float ub = __fadd_rn(__fmul_rn(s[fin * NCA_HFOOT + fj], 0.75f),
                             __fmul_rn(s[fin * NCA_HFOOT + fjn], 0.25f));
  const float p1 = __fadd_rn(__fmul_rn(ua, 0.75f), __fmul_rn(ub, 0.25f));
  return __fmul_rn(__fadd_rn(p0, p1), 0.5f);
}
