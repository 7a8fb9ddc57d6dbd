// The backward of the DyNCA training rollout on NCHW state: two kernels a
// step, launched for step n-1 down to 0. The forward is nca_step.cu, one
// launch a step, with every step's input state kept in a checkpoint buffer
// [n_steps, B, C, H, W] (ops/fused_train.py), so nothing is recomputed
// across steps.
//
// Replaces (vsnca_tpu/ops/pallas_train.py), for circular padding:
//   * _make_bwd_kernel_flat         (:1139, 'gather'; called by _bwd_call_flat
//     :2235),
//   * _make_bwd_kernel_flat_scatter (:1657, 'scatter'; same call site),
//   * _make_bwd_kernel_flat_tiled   (:1301; called by _bwd_call_flat_tiled
//     :2358) with its multiscale adjoint _flat_percept_ms_adj (:185) and its
//     tap injection (:1361-1373, :1542; fused_rollout_train_flat_taps_hw
//     :2458).
// The three differ only in how a TPU core's VMEM holds the perception
// cotangent; they compute one function, the two passes of backward_step
// (:1219-1280), for perception_scales (0,) and, with the kernels' MS forms,
// (0, 1):
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
// Scales (0, 1): nca_bwd_mlp's MS form recomputes the averaged percept
// through nca_step's own device functions (nca_common.cuh::half_percept,
// ms_average), so z1 and the relu gates agree with the forward bit for bit,
// and its gp is the cotangent of the average. nca_bwd_adjoint_ms is the
// transpose of down -> half-res stencils -> clamped up, plus the scale-0
// stencils, averaged 0.5 — in gather form: each block forms U^T gp over W,
// then H, on its 10 x 10 half-pixel footprint from gp in device memory, the
// half-resolution stencil adjoint (circular at half resolution) on its 8 x 8
// half pixels, and adds 0.5 * (scale-0 adjoint + 0.25 * parent's g_h) (D^T
// of the 2x2 mean) to each of its pixels. No atomics and no scratch buffer.
// Frame taps: a tap at state t (the input of step t) adds its cotangent in
// the adjoint launch of step t, right after gx has become the cotangent of
// that state (an optional gtap pointer of both adjoint kernels), so one
// reverse walk serves a whole tapped schedule.
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
// The multiscale adjoint adds per pixel and channel 4 x 22 x 10 / 256 U_W^T
// gathers of 4 reads (from L1/L2) and the half-resolution stencils: bytes
// and latency, not FLOPs; its 9.3 KB of static shared memory leaves room for
// many blocks an SM. nca_bwd_mlp's MS form needs ~182 KB of shared memory
// at c16/fc128/cc2 (one block an SM).
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
// (t as in nca_common.cuh::stencils: a 3x3 window, rows LD floats apart.)
template <int LD = NCA_HALO>
__device__ __forceinline__ float sobel_x_adj(const float* t) {
  // flip(SOBEL_X) = [[1,0,-1],[2,0,-2],[1,0,-1]]
  float a = t[0];
  a = __fadd_rn(a, __fmul_rn(t[2], -1.f));
  a = __fadd_rn(a, __fmul_rn(t[LD], 2.f));
  a = __fadd_rn(a, __fmul_rn(t[LD + 2], -2.f));
  a = __fadd_rn(a, t[2 * LD]);
  return __fadd_rn(a, __fmul_rn(t[2 * LD + 2], -1.f));
}

template <int LD = NCA_HALO>
__device__ __forceinline__ float sobel_y_adj(const float* t) {
  // flip(SOBEL_Y) = [[1,2,1],[0,0,0],[-1,-2,-1]]
  float a = t[0];
  a = __fadd_rn(a, __fmul_rn(t[1], 2.f));
  a = __fadd_rn(a, t[2]);
  a = __fadd_rn(a, __fmul_rn(t[2 * LD], -1.f));
  a = __fadd_rn(a, __fmul_rn(t[2 * LD + 1], -2.f));
  return __fadd_rn(a, __fmul_rn(t[2 * LD + 2], -1.f));
}

// The 3x3 stencil adjoint at one position: raw + the flipped Sobel-x,
// Sobel-y and Laplacian correlations of the three stencil blocks' windows
// (the Laplacian is its own flip), summed in the JAX term order.
template <int LD = NCA_HALO>
__device__ __forceinline__ float stencil_adjoint(float raw, const float* tx,
                                                 const float* ty,
                                                 const float* tl) {
  float sx_unused, sy_unused, lap;
  stencils<LD>(tl, sx_unused, sy_unused, lap);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(raw, sobel_x_adj<LD>(tx)), sobel_y_adj<LD>(ty)), lap);
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
// The C x 18 x 18 state tile (and with MS the half-state tile and the half
// percept, nca_common.cuh::half_percept) lives in hs/gzs and past them until
// the percept is built.
template <bool BF16, bool MS>
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
  float* htile = tile + C * NCA_HALO * NCA_HALO;
  float* hp = htile + C * NCA_HHALO * NCA_HHALO;

  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;

  for (int i = tid; i < P * F4; i += NT_THREADS) w1s[i] = w1[i];
  for (int i = tid; i < C * F4; i += NT_THREADS) {
    const int c = i / F4, f = i % F4;
    w2t[i] = w2[f * C + c];
  }
  for (int i = tid; i < F4; i += NT_THREADS) b1s[i] = b1[i];

  // The forward's percept, through the forward's own device functions
  // (circular padding), so z1 and the relu gates agree bit for bit.
  const float* xb = x + (size_t)b * C * HW;
  stage_tile(tile, xb, C, H, W, blockIdx.y * NCA_TILE - 1,
             blockIdx.x * NCA_TILE - 1, 0, tid, NT_THREADS);
  if (MS) {
    half_percept(htile, hp, xb, C, H, W, blockIdx.y, blockIdx.x, 0, tid,
                 NT_THREADS);
  } else {
    __syncthreads();
  }

  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  const bool valid = px < W && py < H;
  const int pix = valid ? py * W + px : 0;
  int fi = 0, fin = 0, fj = 0, fjn = 0;
  if (MS && valid) {
    upsample_taps(blockIdx.y, threadIdx.y, H, fi, fin);
    upsample_taps(blockIdx.x, threadIdx.x, W, fj, fjn);
  }
  const int nf = NCA_HFOOT * NCA_HFOOT;

  // Percept and gdx columns. A thread past the grid's edge writes zeros,
  // which add nothing to any gradient (its gdx is 0, so is its gz1).
  for (int c = 0; c < C; ++c) {
    float v = 0.f, sx = 0.f, sy = 0.f, lap = 0.f;
    if (valid) {
      const float* t =
          tile + (c * NCA_HALO + threadIdx.y) * NCA_HALO + threadIdx.x;
      stencils(t, sx, sy, lap);
      v = t[NCA_HALO + 1];
      if (MS) {
        v = ms_average(hp + (0 * C + c) * nf, fi, fin, fj, fjn, v);
        sx = ms_average(hp + (1 * C + c) * nf, fi, fin, fj, fjn, sx);
        sy = ms_average(hp + (2 * C + c) * nf, fi, fin, fj, fjn, sy);
        lap = ms_average(hp + (3 * C + c) * nf, fi, fin, fj, fjn, lap);
      }
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

// gx [B, C, H, W] += gp[:, :C] + adjoint stencils of gp[:, C:4C], circular;
// then, when gtap is not null, += gtap [B, C, H, W] (a frame tap's
// cotangent: gx has just become the cotangent of the state it taps).
__global__ void __launch_bounds__(NT_THREADS)
nca_bwd_adjoint_kernel(const float* __restrict__ gp, float* __restrict__ gx,
                       const float* __restrict__ gtap, int C, int H, int W) {
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
      const float adj = stencil_adjoint(gpb[(size_t)c * HW + pix], &tile[0][o],
                                        &tile[1][o], &tile[2][o]);
      const size_t at = ((size_t)b * C + c) * HW + pix;
      float v = __fadd_rn(gx[at], adj);
      if (gtap != nullptr) v = __fadd_rn(v, gtap[at]);
      gx[at] = v;
    }
  }
}

// The transposed clamped 2x upsample at one half pixel of an axis: a and b
// are its two children (full 2i and 2i + 1, weight 0.75 each), l and r the
// 0.25 taps of the neighbouring outputs (full 2i - 1 and 2i + 2; at the
// edges the clamp's own child, 2i at i = 0 and 2i + 1 at i = m - 1). Plain
// version: fused_train.py::upsample2_adjoint.
__device__ __forceinline__ float upsample2_t(float a, float b, float l,
                                             float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, 0.75f), __fmul_rn(b, 0.75f)),
                   __fadd_rn(__fmul_rn(l, 0.25f), __fmul_rn(r, 0.25f)));
}

#define ADJ_WROWS (2 * NCA_HFOOT + 2)  // full rows a footprint's U^T reads

// The multiscale (scales (0, 1)) state cotangent of one step, in gather
// form: for the block's 16 x 16 pixels and each channel c,
//   g_h = S_h^T U^T gp at the 8 x 8 half pixels under the block — U^T over
//         W then over H (upsample2_t) on the 10 x 10 footprint (the 8 x 8
//         and a one-half-pixel ring, wrapped circularly at half
//         resolution), then the half-resolution stencil adjoint;
//   gx += 0.5 * (gx0 + 0.25 * g_h[parent]), gx0 the scale-0 adjoint of gp
//         (0.25 g_h[parent] is D^T g_h, the 2x2 mean's transpose), and
//         gtap's value when gtap is not null.
// Every value is computed where it is used: no atomics, no scratch in
// device memory.
__global__ void __launch_bounds__(NT_THREADS)
nca_bwd_adjoint_ms_kernel(const float* __restrict__ gp, float* __restrict__ gx,
                          const float* __restrict__ gtap, int C, int H,
                          int W) {
  __shared__ float tile[3][NCA_HALO * NCA_HALO];
  __shared__ float wt[4][ADJ_WROWS * NCA_HFOOT];  // U_W^T of 22 full rows
  __shared__ float gph[4][NCA_HFOOT * NCA_HFOOT];  // U^T gp on the footprint
  __shared__ float gh[(NCA_TILE / 2) * (NCA_TILE / 2)];
  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W, H2 = H / 2, W2 = W / 2;
  const int y0 = blockIdx.y * NCA_TILE - 1, x0 = blockIdx.x * NCA_TILE - 1;
  const int hb = blockIdx.y * (NCA_TILE / 2), wb = blockIdx.x * (NCA_TILE / 2);
  const int fr0 = 2 * (hb - 1) - 1;  // full row of wt's first row, mod H
  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  const bool valid = px < W && py < H;
  const int pix = py * W + px;
  const float* gpb = gp + (size_t)b * 4 * C * HW;
  const int o = threadIdx.y * NCA_HALO + threadIdx.x;
  const int nf = NCA_HFOOT * NCA_HFOOT;

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous channel's shared arrays are consumed
    for (int i = tid; i < 3 * NCA_HALO * NCA_HALO; i += NT_THREADS) {
      const int k = i / (NCA_HALO * NCA_HALO);
      const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
      const int row = pad_index(y0 + r, H, 0), col = pad_index(x0 + q, W, 0);
      tile[k][r * NCA_HALO + q] =
          gpb[(size_t)((k + 1) * C + c) * HW + row * W + col];
    }
    for (int i = tid; i < 4 * ADJ_WROWS * NCA_HFOOT; i += NT_THREADS) {
      const int k = i / (ADJ_WROWS * NCA_HFOOT);
      const int lr = (i / NCA_HFOOT) % ADJ_WROWS, q = i % NCA_HFOOT;
      const int row = pad_index(fr0 + lr, H, 0);
      const int j = pad_index(wb - 1 + q, W2, 0);
      const float* g = gpb + (size_t)(k * C + c) * HW + (size_t)row * W;
      wt[k][lr * NCA_HFOOT + q] =
          upsample2_t(g[2 * j], g[2 * j + 1], g[j >= 1 ? 2 * j - 1 : 2 * j],
                      g[j <= W2 - 2 ? 2 * j + 2 : 2 * j + 1]);
    }
    __syncthreads();
    for (int i = tid; i < 4 * nf; i += NT_THREADS) {
      const int k = i / nf, r = (i / NCA_HFOOT) % NCA_HFOOT, q = i % NCA_HFOOT;
      const int hi = pad_index(hb - 1 + r, H2, 0);
      const float* col = &wt[k][q];
      gph[k][r * NCA_HFOOT + q] = upsample2_t(
          col[(2 * r + 1) * NCA_HFOOT], col[(2 * r + 2) * NCA_HFOOT],
          col[(hi >= 1 ? 2 * r : 2 * r + 1) * NCA_HFOOT],
          col[(hi <= H2 - 2 ? 2 * r + 3 : 2 * r + 2) * NCA_HFOOT]);
    }
    __syncthreads();
    if (tid < (NCA_TILE / 2) * (NCA_TILE / 2)) {
      const int r = tid / (NCA_TILE / 2), q = tid % (NCA_TILE / 2);
      const int w0 = r * NCA_HFOOT + q;  // the 3x3 window's top-left
      gh[tid] = stencil_adjoint<NCA_HFOOT>(gph[0][w0 + NCA_HFOOT + 1],
                                          &gph[1][w0], &gph[2][w0],
                                          &gph[3][w0]);
    }
    __syncthreads();
    if (valid) {
      const float adj0 = stencil_adjoint(gpb[(size_t)c * HW + pix], &tile[0][o],
                                         &tile[1][o], &tile[2][o]);
      const float h =
          gh[(threadIdx.y >> 1) * (NCA_TILE / 2) + (threadIdx.x >> 1)];
      const size_t at = ((size_t)b * C + c) * HW + pix;
      float v = __fadd_rn(
          gx[at], __fmul_rn(__fadd_rn(adj0, __fmul_rn(h, 0.25f)), 0.5f));
      if (gtap != nullptr) v = __fadd_rn(v, gtap[at]);
      gx[at] = v;
    }
  }
}

template <bool BF16, bool MS>
static void launch_mlp(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                       const float* x, const float* cond, const float* gx,
                       float* gp, float* dcond, float* slots, const float* w1,
                       const float* b1, const float* w2, int C, int H, int W,
                       int cc, int F4, unsigned int seed, unsigned int step,
                       unsigned int thr) {
  cudaFuncSetAttribute(nca_bwd_mlp_kernel<BF16, MS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nca_bwd_mlp_kernel<BF16, MS><<<grid, block, smem, s>>>(
      x, cond, gx, gp, dcond, slots, w1, b1, w2, C, H, W, cc, F4, seed, step,
      thr);
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
// the step's output. Writes gp [B, 4C, H, W] (the cotangent of the step's
// percept: with ms, of the scales-(0, 1) average); adds into dcond
// [B, cc, H, W] when it is not null, and into slots [n_blocks, S] with
// n_blocks = ceil(W/16) * ceil(H/16) * B and S = P*F4 + F4 + F4*C + C
// (dW1 [P, F4], db1 [F4], dW2 [F4, C], db2 [C]). w1 [P, F4], b1 [F4],
// w2 [F4, C] as nca_step takes them. Circular padding; ms needs even H and
// W. Returns cudaGetLastError().
int nca_bwd_mlp_launch(const float* x, const float* cond, const float* gx,
                       float* gp, float* dcond, float* slots, const float* w1,
                       const float* b1, const float* w2, int B, int C, int H,
                       int W, int cc, int F4, int bf16, int ms,
                       unsigned int seed, unsigned int step, unsigned int thr,
                       void* stream) {
  if (C < 1 || C > NCA_C_MAX || cc < 0 || cc > NCA_CC_MAX || F4 < 4 ||
      F4 > NCA_F_MAX || F4 % 4 != 0 || (ms && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  const int P = 4 * C + cc;
  // hs/gzs hold the state tile (and with ms the half tile and percept)
  // until the percept columns are built
  size_t scratch = (size_t)C * NCA_HALO * NCA_HALO;
  if (ms)
    scratch += (size_t)C * (NCA_HHALO * NCA_HHALO + 4 * NCA_HFOOT * NCA_HFOOT);
  if (scratch < (size_t)2 * NT_FC * NT_LD) scratch = (size_t)2 * NT_FC * NT_LD;
  const size_t smem =
      sizeof(float) * ((size_t)P * F4 + (size_t)C * F4 + F4 +
                       (size_t)(P + C) * NT_LD + scratch);
  const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE,
                  B);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && ms)
    launch_mlp<true, true>(grid, block, smem, s, x, cond, gx, gp, dcond, slots,
                           w1, b1, w2, C, H, W, cc, F4, seed, step, thr);
  else if (bf16)
    launch_mlp<true, false>(grid, block, smem, s, x, cond, gx, gp, dcond, slots,
                            w1, b1, w2, C, H, W, cc, F4, seed, step, thr);
  else if (ms)
    launch_mlp<false, true>(grid, block, smem, s, x, cond, gx, gp, dcond, slots,
                            w1, b1, w2, C, H, W, cc, F4, seed, step, thr);
  else
    launch_mlp<false, false>(grid, block, smem, s, x, cond, gx, gp, dcond,
                             slots, w1, b1, w2, C, H, W, cc, F4, seed, step,
                             thr);
  return (int)cudaGetLastError();
}

// One backward step's second pass, in place, circular: gx += the state
// cotangent of the percept cotangent gp — gp[:, :C] + the flipped-stencil
// adjoint of gp[:, C:4C] (scales (0,)), or with ms the multiscale adjoint
// (nca_bwd_adjoint_ms; even H and W) — then += gtap [B, C, H, W] when it is
// not null. Returns cudaGetLastError().
int nca_bwd_adjoint_launch(const float* gp, float* gx, const float* gtap,
                           int B, int C, int H, int W, int ms, void* stream) {
  if (C < 1 || C > NCA_C_MAX || (ms && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE,
                  B);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ms)
    nca_bwd_adjoint_ms_kernel<<<grid, block, 0, s>>>(gp, gx, gtap, C, H, W);
  else
    nca_bwd_adjoint_kernel<<<grid, block, 0, s>>>(gp, gx, gtap, C, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
