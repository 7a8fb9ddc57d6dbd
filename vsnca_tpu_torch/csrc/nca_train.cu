// The backward of the DyNCA training rollout on NCHW state: two kernels a
// step, launched for step n-1 down to 0. The forward is nca_step.cu, one
// launch a step, with every step's input state kept in a checkpoint buffer
// [n_steps, B, C, H, W] (ops/fused_train.py), so nothing is recomputed
// across steps.
//
// Replaces (vsnca_tpu/ops/pallas_train.py), for perception_scales (0,) and
// circular padding:
//   * _make_bwd_kernel_flat         (:1139, 'gather'; called by _bwd_call_flat
//     :2235),
//   * _make_bwd_kernel_flat_scatter (:1657, 'scatter'; same call site),
//   * _make_bwd_kernel_flat_tiled   (:1301; called by _bwd_call_flat_tiled
//     :2358) without its multiscale adjoint and tap injection.
// The three differ only in how a TPU core's VMEM holds the perception
// cotangent; they compute one function, the two passes of backward_step
// (:1219-1280):
//   nca_bwd_mlp     — recompute the percept p (halo tile, circular wrap),
//     z1 = W1^T p + b1, the mask; gdx = gx * mask,
//     gz1 = (W2 gdx) * [z1 > 0], gp = W1 gz1 (the 4C percept rows to a
//     [B, 4C, H, W] buffer, the conditioning rows added into dcond), and
//     the block's partial dW1 += gz1 (x) p, db1 += gz1, dW2 += hid (x) gdx,
//     db2 += gdx in the block's own slot of a [n_blocks, S] buffer (the
//     same block owns the same pixels every step: no atomics, a
//     deterministic sum, which the wrapper takes once per call);
//   nca_bwd_adjoint — gx += gp[raw] + the adjoint Sobel-x, Sobel-y and
//     Laplacian stencils of gp: correlation with the 180-degree flipped
//     filters under circular wrap (_flip :68), read from a halo tile of gp.
//     Each thread reads and writes only its own pixel of gx, so it updates
//     gx in place; launched after nca_bwd_mlp on the same stream, which has
//     read gx by then.
//
// What bounds it on an H100: per pixel and step nca_bwd_mlp does the
// forward's first layer again (z1 = W1^T p, P*F FMAs; the second layer is
// not recomputed) plus W2 gdx (F*C), W1 gz1 (P*F) and the weight-gradient
// outer products (P*F + F*C): 2*(3*P*F + 2*F*C) FLOP, 33.4 kFLOP at
// c12/fc96/pos_emb, against ~32 C*4 + cc*4 bytes of state, cond, gx and gp.
// Arithmetic bounds it: float32 FMAs on the CUDA cores (67 TFLOP/s).
//
// What the design does about it (simple first; the wgmma/TMA redesign is
// ROADMAP B7): one thread per pixel in 16x16 blocks like nca_step. The
// percept, gdx and, chunk by chunk of 16 hidden units, hid and gz1 live in
// shared memory as per-pixel columns (stride 257 floats, so a warp reading
// 32 different rows at one pixel hits 32 banks). Each thread keeps its gp
// (up to 68 values) in registers. The weight gradients are then small
// products over the block's 256 pixels in shared memory — 256 threads each
// own a few (row, unit) outputs and walk the pixels — instead of a
// 96 x 50 outer product per thread or atomics.
//
// bf16 mode rounds where the TPU kernel casts to its compute dtype
// (:1232-1238): the percept (with the conditioning rows), hid, gdx and gz1;
// W1 and W2 come rounded from the wrapper's packing. Accumulation, gp and
// the adjoint stay float32.

#include "nca_common.cuh"

#define NT_THREADS (NCA_TILE * NCA_TILE)
#define NT_FC 16                // hidden units per chunk
#define NT_LD (NT_THREADS + 1)  // stride of the per-pixel columns

// The adjoint stencils: the flipped filters in the JAX term order
// (_stencil_from over SOBEL_X_F, SOBEL_Y_F, LAPLACIAN_F).
__device__ __forceinline__ float sobel_x_adj(const float* t) {
  // flip(SOBEL_X) = [[1,0,-1],[2,0,-2],[1,0,-1]]
  float a = t[0];
  a = __fadd_rn(a, __fmul_rn(t[2], -1.f));
  a = __fadd_rn(a, __fmul_rn(t[NCA_HALO], 2.f));
  a = __fadd_rn(a, __fmul_rn(t[NCA_HALO + 2], -2.f));
  a = __fadd_rn(a, t[2 * NCA_HALO]);
  return __fadd_rn(a, __fmul_rn(t[2 * NCA_HALO + 2], -1.f));
}

__device__ __forceinline__ float sobel_y_adj(const float* t) {
  // flip(SOBEL_Y) = [[1,2,1],[0,0,0],[-1,-2,-1]]
  float a = t[0];
  a = __fadd_rn(a, __fmul_rn(t[1], 2.f));
  a = __fadd_rn(a, t[2]);
  a = __fadd_rn(a, __fmul_rn(t[2 * NCA_HALO], -1.f));
  a = __fadd_rn(a, __fmul_rn(t[2 * NCA_HALO + 1], -2.f));
  return __fadd_rn(a, __fmul_rn(t[2 * NCA_HALO + 2], -1.f));
}

// Shared memory, float32, in this order (the float4-read parts first, each
// a multiple of 4 floats long):
//   w1s [P, F4]   W1, input-major, rows in the percept's block order
//   w2t [C, F4]   W2 transposed
//   b1s [F4]
//   ps  [P, LD]   percept, one column per pixel of the block
//   gds [C, LD]   gdx
//   hs  [FC, LD]  hid of the current chunk of hidden units
//   gzs [FC, LD]  gz1 of the current chunk
// The C x 18 x 18 state tile lives in hs/gzs until the percept is built.
template <bool BF16>
__global__ void __launch_bounds__(NT_THREADS)
nca_bwd_mlp_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                   const float* __restrict__ gx, float* __restrict__ gp,
                   float* __restrict__ dcond, float* __restrict__ slots,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, int C, int H, int W, int cc,
                   int F4, uint32_t seed, uint32_t step, uint32_t thr) {
  extern __shared__ __align__(16) float smem[];
  const int P = 4 * C + cc;
  float* w1s = smem;
  float* w2t = w1s + P * F4;
  float* b1s = w2t + C * F4;
  float* ps = b1s + F4;
  float* gds = ps + P * NT_LD;
  float* hs = gds + C * NT_LD;
  float* gzs = hs + NT_FC * NT_LD;
  float* tile = hs;

  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;

  for (int i = tid; i < P * F4; i += NT_THREADS) w1s[i] = w1[i];
  for (int i = tid; i < C * F4; i += NT_THREADS) {
    const int c = i / F4, f = i % F4;
    w2t[i] = w2[f * C + c];
  }
  for (int i = tid; i < F4; i += NT_THREADS) b1s[i] = b1[i];

  const int y0 = blockIdx.y * NCA_TILE - 1, x0 = blockIdx.x * NCA_TILE - 1;
  const float* xb = x + (size_t)b * C * HW;
  for (int i = tid; i < C * NCA_HALO * NCA_HALO; i += NT_THREADS) {
    const int c = i / (NCA_HALO * NCA_HALO);
    const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
    const int row = pad_index(y0 + r, H, 0), col = pad_index(x0 + q, W, 0);
    tile[i] = xb[(size_t)c * HW + row * W + col];
  }
  __syncthreads();

  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  const bool valid = px < W && py < H;
  const int pix = valid ? py * W + px : 0;

  // Percept and gdx columns. A thread past the grid's edge writes zeros,
  // which add nothing to any gradient (its gdx is 0, so is its gz1).
  for (int c = 0; c < C; ++c) {
    float v = 0.f, sx = 0.f, sy = 0.f, lap = 0.f;
    if (valid) {
      const float* t =
          tile + (c * NCA_HALO + threadIdx.y) * NCA_HALO + threadIdx.x;
      stencils(t, sx, sy, lap);
      v = t[NCA_HALO + 1];
    }
    if (BF16) {
      v = bf16_round(v);
      sx = bf16_round(sx);
      sy = bf16_round(sy);
      lap = bf16_round(lap);
    }
    ps[c * NT_LD + tid] = v;
    ps[(C + c) * NT_LD + tid] = sx;
    ps[(2 * C + c) * NT_LD + tid] = sy;
    ps[(3 * C + c) * NT_LD + tid] = lap;
  }
  for (int j = 0; j < cc; ++j) {
    float v = valid ? cond[((size_t)b * cc + j) * HW + pix] : 0.f;
    ps[(4 * C + j) * NT_LD + tid] = BF16 ? bf16_round(v) : v;
  }
  const bool on =
      valid && (mask_bits(seed, (uint32_t)b, step, (uint32_t)pix) >> 8) >= thr;
  for (int c = 0; c < C; ++c) {
    const float g = on ? gx[((size_t)b * C + c) * HW + pix] : 0.f;
    gds[c * NT_LD + tid] = BF16 ? bf16_round(g) : g;
  }
  __syncthreads();  // the state tile is dead: hs/gzs take its memory

  float gpa[4][NCA_C_MAX], gpc[NCA_CC_MAX];
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c)
    gpa[0][c] = gpa[1][c] = gpa[2][c] = gpa[3][c] = 0.f;
#pragma unroll
  for (int j = 0; j < NCA_CC_MAX; ++j) gpc[j] = 0.f;

  const size_t slot_floats = (size_t)P * F4 + F4 + (size_t)F4 * C + C;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* sdw1 = slots + blk * slot_floats;  // [P, F4]
  float* sdb1 = sdw1 + P * F4;              // [F4]
  float* sdw2 = sdb1 + F4;                  // [F4, C]
  float* sdb2 = sdw2 + F4 * C;              // [C]

  for (int f0 = 0; f0 < F4; f0 += NT_FC) {
    // This pixel's z1 and W2 gdx for hidden units f0 .. f0 + 15.
    float z[NT_FC], g2[NT_FC];
#pragma unroll
    for (int i = 0; i < NT_FC; ++i) z[i] = g2[i] = 0.f;
    for (int k = 0; k < P; ++k) {
      const float pk = ps[k * NT_LD + tid];
      const float* wr = w1s + k * F4 + f0;
#pragma unroll
      for (int q = 0; q < NT_FC / 4; ++q) {
        if (f0 + 4 * q < F4) {
          const float4 w = *reinterpret_cast<const float4*>(wr + 4 * q);
          z[4 * q + 0] = fmaf(w.x, pk, z[4 * q + 0]);
          z[4 * q + 1] = fmaf(w.y, pk, z[4 * q + 1]);
          z[4 * q + 2] = fmaf(w.z, pk, z[4 * q + 2]);
          z[4 * q + 3] = fmaf(w.w, pk, z[4 * q + 3]);
        }
      }
    }
    for (int c = 0; c < C; ++c) {
      const float gd = gds[c * NT_LD + tid];
      const float* wr = w2t + c * F4 + f0;
#pragma unroll
      for (int q = 0; q < NT_FC / 4; ++q) {
        if (f0 + 4 * q < F4) {
          const float4 w = *reinterpret_cast<const float4*>(wr + 4 * q);
          g2[4 * q + 0] = fmaf(w.x, gd, g2[4 * q + 0]);
          g2[4 * q + 1] = fmaf(w.y, gd, g2[4 * q + 1]);
          g2[4 * q + 2] = fmaf(w.z, gd, g2[4 * q + 2]);
          g2[4 * q + 3] = fmaf(w.w, gd, g2[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT_FC; ++i) {
      float hid = 0.f, gz = 0.f;
      if (f0 + i < F4) {
        const float zz = z[i] + b1s[f0 + i];
        hid = fmaxf(zz, 0.f);
        gz = zz > 0.f ? g2[i] : 0.f;
        if (BF16) {
          hid = bf16_round(hid);
          gz = bf16_round(gz);
        }
      }
      hs[i * NT_LD + tid] = hid;
      gzs[i * NT_LD + tid] = gz;
    }

    // gp += W1 gz1 over this chunk (gz1 read back from this thread's own
    // column, four units at a time).
    for (int q = 0; q < NT_FC && f0 + q < F4; q += 4) {
      const float g0 = gzs[q * NT_LD + tid], g1 = gzs[(q + 1) * NT_LD + tid];
      const float g2v = gzs[(q + 2) * NT_LD + tid];
      const float g3 = gzs[(q + 3) * NT_LD + tid];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < NCA_C_MAX; ++c) {
          if (c < C) {
            const float4 w = *reinterpret_cast<const float4*>(
                w1s + (k * C + c) * F4 + f0 + q);
            float a = gpa[k][c];
            a = fmaf(w.x, g0, a);
            a = fmaf(w.y, g1, a);
            a = fmaf(w.z, g2v, a);
            gpa[k][c] = fmaf(w.w, g3, a);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NCA_CC_MAX; ++j) {
        if (j < cc) {
          const float4 w = *reinterpret_cast<const float4*>(
              w1s + (4 * C + j) * F4 + f0 + q);
          float a = gpc[j];
          a = fmaf(w.x, g0, a);
          a = fmaf(w.y, g1, a);
          a = fmaf(w.z, g2v, a);
          gpc[j] = fmaf(w.w, g3, a);
        }
      }
    }
    __syncthreads();

    // The block's sums over its 256 pixels for this chunk: dW1 [P, nf],
    // db1 [nf], dW2 [nf, C], each output walked by one thread in pixel
    // order, added into the block's slot.
    const int nf = min(NT_FC, F4 - f0);
    const int n1 = P * nf, n2 = nf * C;
    for (int o = tid; o < n1 + nf + n2; o += NT_THREADS) {
      float s = 0.f;
      if (o < n1) {
        const int k = o / nf, i = o % nf;
        const float* a = ps + k * NT_LD;
        const float* g = gzs + i * NT_LD;
#pragma unroll 8
        for (int t = 0; t < NT_THREADS; ++t) s = fmaf(a[t], g[t], s);
        sdw1[k * F4 + f0 + i] += s;
      } else if (o < n1 + nf) {
        const float* g = gzs + (o - n1) * NT_LD;
#pragma unroll 8
        for (int t = 0; t < NT_THREADS; ++t) s += g[t];
        sdb1[f0 + o - n1] += s;
      } else {
        const int r = o - n1 - nf;
        const int i = r / C, c = r % C;
        const float* hh = hs + i * NT_LD;
        const float* gd = gds + c * NT_LD;
#pragma unroll 8
        for (int t = 0; t < NT_THREADS; ++t) s = fmaf(gd[t], hh[t], s);
        sdw2[(f0 + i) * C + c] += s;
      }
    }
    __syncthreads();  // the next chunk rewrites hs/gzs
  }

  for (int c = tid; c < C; c += NT_THREADS) {
    float s = 0.f;
    for (int t = 0; t < NT_THREADS; ++t) s += gds[c * NT_LD + t];
    sdb2[c] += s;
  }
  if (!valid) return;
  float* gpb = gp + (size_t)b * 4 * C * HW + pix;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < NCA_C_MAX; ++c)
      if (c < C) gpb[(size_t)(k * C + c) * HW] = gpa[k][c];
  }
  if (dcond != nullptr) {
#pragma unroll
    for (int j = 0; j < NCA_CC_MAX; ++j)
      if (j < cc) dcond[((size_t)b * cc + j) * HW + pix] += gpc[j];
  }
}

// gx [B, C, H, W] += gp[:, :C] + adjoint stencils of gp[:, C:4C], circular.
__global__ void __launch_bounds__(NT_THREADS)
nca_bwd_adjoint_kernel(const float* __restrict__ gp, float* __restrict__ gx,
                       int C, int H, int W) {
  __shared__ float tile[3][NCA_HALO * NCA_HALO];
  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int y0 = blockIdx.y * NCA_TILE - 1, x0 = blockIdx.x * NCA_TILE - 1;
  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  const bool valid = px < W && py < H;
  const int pix = py * W + px;
  const float* gpb = gp + (size_t)b * 4 * C * HW;
  const int o = threadIdx.y * NCA_HALO + threadIdx.x;

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous channel's tiles are consumed
    for (int i = tid; i < 3 * NCA_HALO * NCA_HALO; i += NT_THREADS) {
      const int k = i / (NCA_HALO * NCA_HALO);
      const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
      const int row = pad_index(y0 + r, H, 0), col = pad_index(x0 + q, W, 0);
      tile[k][r * NCA_HALO + q] =
          gpb[(size_t)((k + 1) * C + c) * HW + row * W + col];
    }
    __syncthreads();
    if (valid) {
      float sx_unused, sy_unused, lap;  // the Laplacian is its own flip
      stencils(&tile[2][o], sx_unused, sy_unused, lap);
      const float adj = __fadd_rn(
          __fadd_rn(__fadd_rn(gpb[(size_t)c * HW + pix], sobel_x_adj(&tile[0][o])),
                    sobel_y_adj(&tile[1][o])),
          lap);
      float* g = gx + ((size_t)b * C + c) * HW + pix;
      *g = __fadd_rn(*g, adj);
    }
  }
}

extern "C" {

// Sizes past these limits are refused by the wrapper before launch.
int nca_train_limits(int* c_max, int* cc_max, int* f_max) {
  *c_max = NCA_C_MAX;
  *cc_max = NCA_CC_MAX;
  *f_max = NCA_F_MAX;
  return 0;
}

// One backward step's first pass. x [B, C, H, W] is the step's input state,
// cond [B, cc, H, W] or null when cc == 0, gx [B, C, H, W] the cotangent of
// the step's output. Writes gp [B, 4C, H, W]; adds into dcond [B, cc, H, W]
// when it is not null, and into slots [n_blocks, S] with n_blocks =
// ceil(W/16) * ceil(H/16) * B and S = P*F4 + F4 + F4*C + C (dW1 [P, F4],
// db1 [F4], dW2 [F4, C], db2 [C]). w1 [P, F4], b1 [F4], w2 [F4, C] as
// nca_step takes them. Circular padding. Returns cudaGetLastError().
int nca_bwd_mlp_launch(const float* x, const float* cond, const float* gx,
                       float* gp, float* dcond, float* slots, const float* w1,
                       const float* b1, const float* w2, int B, int C, int H,
                       int W, int cc, int F4, int bf16, unsigned int seed,
                       unsigned int step, unsigned int thr, void* stream) {
  if (C < 1 || C > NCA_C_MAX || cc < 0 || cc > NCA_CC_MAX || F4 < 4 ||
      F4 > NCA_F_MAX || F4 % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int P = 4 * C + cc;
  const size_t smem =
      sizeof(float) * ((size_t)P * F4 + (size_t)C * F4 + F4 +
                       (size_t)(P + C + 2 * NT_FC) * NT_LD);
  const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE,
                  B);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(nca_bwd_mlp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    nca_bwd_mlp_kernel<true><<<grid, block, smem, s>>>(
        x, cond, gx, gp, dcond, slots, w1, b1, w2, C, H, W, cc, F4, seed, step,
        thr);
  } else {
    cudaFuncSetAttribute(nca_bwd_mlp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    nca_bwd_mlp_kernel<false><<<grid, block, smem, s>>>(
        x, cond, gx, gp, dcond, slots, w1, b1, w2, C, H, W, cc, F4, seed, step,
        thr);
  }
  return (int)cudaGetLastError();
}

// One backward step's second pass: gx += gp[:, :C] + the flipped-stencil
// adjoint of gp[:, C:4C], in place, circular. Returns cudaGetLastError().
int nca_bwd_adjoint_launch(const float* gp, float* gx, int B, int C, int H,
                           int W, void* stream) {
  if (C < 1 || C > NCA_C_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE,
                  B);
  const dim3 block(NCA_TILE, NCA_TILE);
  nca_bwd_adjoint_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, gx, C, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
