// Pieces shared by the kernels (nca_step.cu, nca_train.cu, nca_cnca.cu): the
// tile geometry, the size limits, the update-mask hash, bf16 rounding and
// the state's storage types, the padding rule, the perception stencils, the
// multiscale (scales (0, 1)) percept, cp.async, and the staging of the two
// single-scale stencil adjoints. Every kernel that includes this draws the
// same masks, rounds the same way and forms the same percept bit for bit.

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

// The single-scale stencil adjoints (nca_train.cu::nca_bwd_adjoint,
// nca_cnca.cu::cnca_bwd_adjoint): a block's tile is SA_TW pixels wide (one
// 128-byte line of a row) and SA_TH tall, a thread 4 pixels of one row. A
// staged plane holds the tile's footprint, SA_FR rows from y0 - 1 and SA_FC
// columns from x0 - 4 (the 34 that the 3x3 windows read, widened to ten
// aligned float4s), rows SA_FC floats apart.
#define SA_TW 32
#define SA_TH 16
#define SA_THREADS (SA_TW / 4 * SA_TH)
#define SA_FR (SA_TH + 2)
#define SA_FC (SA_TW + 8)
#define SA_PLANE (SA_FR * SA_FC)
#define SA_SLOTS ((SA_PLANE + SA_THREADS - 1) / SA_THREADS)

// A thread's copies of one staged plane, the same for every plane of its
// block: slot j is unit i = tid + j * SA_THREADS of the footprint (a float4
// when vec, a float otherwise), off[j] its source offset within a plane, -1
// where the padding puts a constant (zero padding outside the grid), -2 past
// the footprint. The circular wrap (wrap) or the zero padding is resolved
// here, once a block; with vec, W is a multiple of 4, so a float4 of the
// footprint wraps, or lies outside the grid, as a whole.
__device__ __forceinline__ void plane_slots(int off[SA_SLOTS], int y0, int x0, int H, int W,
                                            bool wrap, bool vec, int tid) {
  const int units = vec ? SA_PLANE / 4 : SA_PLANE;
#pragma unroll
  for (int j = 0; j < SA_SLOTS; ++j) {
    const int i = tid + j * SA_THREADS;
    const int r = vec ? i / (SA_FC / 4) : i / SA_FC;
    const int q = vec ? 4 * (i - r * (SA_FC / 4)) : i - r * SA_FC;
    int gy = y0 - 1 + r, gx = x0 - 4 + q;
    if (wrap) {
      gy = pad_index(gy, H, 0);
      gx = pad_index(gx, W, 0);
    }
    off[j] = i >= units ? -2 : (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * W + gx : -1;
  }
}

// Stage one plane (src, a [H, W] plane of device memory) into dst [SA_FR,
// SA_FC] by the thread's slots: asynchronous copies (16-byte ones when vec),
// `fill` by plain stores where off is -1. The caller commits, waits and
// synchronises before reading dst.
__device__ __forceinline__ void stage_plane(float* dst, const float* src,
                                            const int off[SA_SLOTS], float fill, bool vec,
                                            int tid) {
#pragma unroll
  for (int j = 0; j < SA_SLOTS; ++j) {
    const int i = tid + j * SA_THREADS;
    if (vec && off[j] >= 0)
      cp_async16(dst + 4 * i, src + off[j]);
    else if (vec && off[j] == -1)
      *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(fill, fill, fill, fill);
    else if (off[j] >= 0)
      cp_async4(dst + i, src + off[j]);
    else if (off[j] == -1)
      dst[i] = fill;
  }
}

// The 3 x 6 window of a staged plane under a thread's 4 pixels (row r,
// columns 4j .. 4j + 3 of the tile): footprint rows r .. r + 2, columns
// 4j + 3 .. 4j + 8; pixel q's 3x3 window starts at w[0][q].
__device__ __forceinline__ void plane_window(float w[3][6], const float* plane, int r, int j) {
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    const float* row = plane + (r + rr) * SA_FC + 4 * j;
    const float4 v = *reinterpret_cast<const float4*>(row + 4);
    w[rr][0] = row[3];
    w[rr][1] = v.x;
    w[rr][2] = v.y;
    w[rr][3] = v.z;
    w[rr][4] = v.w;
    w[rr][5] = row[8];
  }
}

// A thread's 4 pixels of a row in device memory, p at the first, n of them
// in the grid (0 .. 4): one float4 when vec and all 4 are (p 16-byte
// aligned), else one float at a time; zeros past the grid.
__device__ __forceinline__ void load_px4(float v[4], const float* p, int n, bool vec) {
  if (vec && n == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? p[q] : 0.f;
  }
}

__device__ __forceinline__ void store_px4(float* p, const float v[4], int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) p[q] = v[q];
  }
}

// cp_async_wait_group<n> for a count known at run time (n <= 3).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3)
    cp_async_wait_group<3>();
  else if (n == 2)
    cp_async_wait_group<2>();
  else if (n == 1)
    cp_async_wait_group<1>();
  else
    cp_async_wait_group<0>();
}
