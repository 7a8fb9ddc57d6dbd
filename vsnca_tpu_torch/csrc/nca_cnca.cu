// The ConditionedNCA (encoder-conditioned) step, forward and backward, on
// NCHW state — the Hopper kernels of the grower's rollout and of the
// encoder trainer's differentiable rollout.
//
// Replaces (vsnca_tpu/ops/pallas_cnca.py):
//   * _make_cnca_kernel           (:47, called by fused_cnca_rollout :250),
//   * _make_cnca_fwd_train_kernel (:350, called by _cnca_train_fwd_call :610),
//   * _make_cnca_bwd_train_kernel (:434, called by _cnca_train_bwd_call :675).
// One step (models/conditioned_nca.py:87-122): pre = maxpool3x3(alpha) > thr;
// xg = x + goal * pre; the learnable depthwise 3x3 percept of xg (3 filters a
// channel, zero padding, rows c*3 + s); h1 = relu(W1^T p + b1), h2 =
// relu(W2^T h1 + b2), dx = W3^T h2; xn = x + dx * fire (one Bernoulli mask a
// pixel); post = maxpool3x3(xn alpha) > thr; out = clamp(xn * (pre & post)).
//
// Four kernels:
//   cnca_update      — pre, xg, percept, MLP, fire mask: xn (before the gate);
//   cnca_gate        — the life gate and the clamp, and the life mask;
//   cnca_bwd_mlp     — one reverse step's recompute and MLP adjoint;
//   cnca_bwd_adjoint — the depthwise percept's adjoint into the state and
//                      goal cotangents.
// The forward of the rollout and of the training pair is cnca_update then
// cnca_gate, a step; the training forward keeps every step's input state in
// a trace and its life mask in bytes (ops/fused_cnca.py), the backward is
// cnca_bwd_mlp then cnca_bwd_adjoint a step, steps in reverse.
//
// Why the gate is a launch of its own: post pools the UPDATED alpha over a
// pixel's 3x3 neighbourhood, so a 16 x 16 tile needs xn on its 1-pixel ring,
// i.e. the MLP (19.5 kFLOP a pixel, the whole cost) on 18 x 18 = 1.27x the
// pixels, with pre on 20 x 20. A second launch that reads xn back costs
// 2 * C * 4 bytes a pixel, about 1/100 of the MLP's time at the float32
// rate, and keeps both kernels simple. The state ping-pongs (x -> xn -> out,
// three buffers), since the gate reads its neighbours' values. The backward
// needs post too: the gate stores the life mask (one byte a pixel a step,
// 3.1 MB at batch 8 x 96 steps x 64^2) rather than the backward recomputing
// the MLP on the ring.
//
// What bounds it on an H100: per pixel and step the update does
// 2 * (3C*D + D*D + D*C) + 2 * 27 * C FLOP (19.5 k at C = 20, D = 64) against
// ~3 * C * 4 bytes (state in, goal, xn out): 80 FLOP a byte, float32
// arithmetic (67 TFLOP/s) bounds it. cnca_bwd_mlp recomputes the forward and
// does the three transposed products and the three weight-gradient
// products: about 3x the update's FLOPs, of which the recompute (the relu
// and clamp gates must be the forward's bits) is a third. cnca_gate and
// cnca_bwd_adjoint are bound by their bytes: cnca_bwd_adjoint reads gp (3C
// floats a pixel), alpha, g and dgoal and writes g and dgoal, 18.5 MB at
// 64^2 b8 C 20, 5.5 us at 3.35 TB/s. Its first design walked the C
// channels one at a time in a 16 x 16 block, two barriers and a scalar,
// bounds-checked load of a 3 x 18 x 18 gp tile a channel, in a grid of 128
// blocks at 64^2 b8 (fewer than the SMs): latency, not bytes. The design
// now spreads channel pairs over the grid (640 blocks there), stages each
// channel's planes once by cp.async and takes pre from a staged alpha
// plane once a block; see cnca_bwd_adjoint_kernel.
//
// What the design does about it: cnca_update and cnca_bwd_mlp's recompute
// are one code path (stage_mat_async, stage_pre, stage_xg_async,
// percept_cols, relu_layer, dx_layer) on a 16 x 8 block of 256 threads: the
// weights and the x and goal tiles staged by cp.async, the percept two
// threads a pixel, h1, h2 and dx a thread 8 units (4 channels) x 4 pixels
// as float32 FMA chains, so each broadcast float4 weight read feeds 16
// FMAs, written as per-pixel columns in shared memory (stride 132 floats,
// so every fragment read of the backward is free of bank conflicts). The
// update keeps only what it needs (h2 over the percept's columns: 108.8 KB
// at C = 20, D = 64, two blocks an SM; 64^2 b8 is 256 blocks); it stays an
// FMA chain because the training pair's backward must recompute its relu
// and clamp gates bit for bit (a tensor-core form reaches other bits).
// Its first design ran one thread a pixel in 16 x 16 blocks (128 blocks at
// 64^2 b8, fewer than the SMs), every weight read feeding 4 FMAs.
// cnca_bwd_mlp then runs every backward product on the tensor cores as
// warp-level mma.sync (nca_mma.cuh; float32 compute in split TF32, bf16
// compute in bf16, float32 accumulators): each warp takes 16 pixels
// through g_h2 = (W3 g_dx)[h2 > 0], g_h1 = (W2 g_h2)[h1 > 0] and
// g_p = W1 g_h1, each product's output registers feeding the next as its A
// operand, and the block forms
// dW3 = h2^T g_dx, dW2 = h1^T g_h2 (db2 as a ones row of h1) and
// dW1 = p^T g_h1 (db1 as a ones row of p) over its 128 pixels, a warp
// taking a run of 16 x 8 output tiles that share their A rows and adding
// each once into the block's own slot of a [n_blocks, S] buffer. The
// depthwise weight gradient (27 C outputs) stays on the CUDA cores, walking
// the tile's rows and columns. About 187 KB of shared memory at C = 20,
// D = 64 allows one block (8 warps, twice the first design's 4) an SM;
// 64^2 b8 is 256 blocks. Measured on the H100 (PERF.md §6): 0.13 ms at
// 64^2 b8 against 0.40 for the first design.
// The same block owns the same pixels every step, so the sum is
// deterministic without atomics; the wrapper sums the slots once per call.
//
// Rounding: the percept's 9 taps are summed as the plain version sums them
// (products and sums unfused, in tap order), and xg as x + goal * pre.
// bf16 mode rounds where the TPU kernels cast (pallas_cnca.py:129, 136, 141
// forward; :497-503, :520, :529, :538 backward): the percept, h1 and h2 as
// operands, g_dx, g_h2 and g_h1; W1..W3 come rounded from the wrapper's
// packing. Biases, wcol, the state and every sum stay float32. The alive
// pools fill the grid's edge with zeros, which gives the reference's -inf
// padding because the threshold is positive (the wrapper refuses thr <= 0).
// Fire masks come from nca_common.cuh::mask_bits(seed, batch, step, pixel),
// so the plain version and the backward draw the same ones.

#include "nca_common.cuh"
#include "nca_mma.cuh"

#define CNCA_C_MAX 24
#define CNCA_D_MAX 64
#define CNCA_P_MAX (3 * CNCA_C_MAX)

#define CB_TX 16                 // cnca_update, cnca_bwd_mlp: 16 wide, 8 tall
#define CB_TY 8
#define CB_PIX (CB_TX * CB_TY)
#define CB_THREADS (2 * CB_PIX)  // two threads a pixel
#define CB_LDM (CB_PIX + 4)      // stride of the per-pixel columns
#define CB_KC 32                 // channels padded to two depth blocks of 16
#define CB_LD3 (CB_KC + 4)       // stride of W3's rows in shared memory
#define CB_NTD (CNCA_D_MAX / 8)  // 8-wide tiles of the hidden units
#define CB_NTP ((CNCA_P_MAX + 8) / 8)  // 8-wide tiles of [p | 1]
#define CB_HX (CB_TX + 2)
#define CB_HY (CB_TY + 2)
#define CB_AX (CB_TX + 4)
#define CB_AY (CB_TY + 4)

__device__ __forceinline__ float rnd_if(bool bf16, float v) {
  return bf16 ? bf16_round(v) : v;
}

// The 3 percept values of one channel: t points at the top-left of the
// pixel's 3x3 window in an xg tile with rows ld floats apart, wc at the
// channel's 27 weights (slot, kh, kw).
__device__ __forceinline__ void percept3(const float* t, int ld, const float* wc,
                                         float out[3]) {
  float v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = t[(k / 3) * ld + k % 3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float a = __fmul_rn(v[0], wc[s * 9]);
#pragma unroll
    for (int k = 1; k < 9; ++k) a = __fadd_rn(a, __fmul_rn(v[k], wc[s * 9 + k]));
    out[s] = a;
  }
}

// Stage the zero-filled alpha tile (ay x ax at (ay0, ax0)), then the pre mask
// over its inner (ay - 2) x (ax - 2), as 1.f / 0.f; ones without the living
// channel. Ends with the block synchronised.
__device__ __forceinline__ void stage_pre(const float* xa, float* at, float* pre, int ay,
                                          int ax, int ay0, int ax0, int H, int W,
                                          float athr, int use_life, int tid, int nthr) {
  if (use_life) {
    for (int i = tid; i < ay * ax; i += nthr) {
      const int gy = ay0 + i / ax, gx = ax0 + i % ax;
      at[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xa[gy * W + gx] : 0.f;
    }
  }
  __syncthreads();
  const int py = ay - 2, px = ax - 2;
  for (int i = tid; i < py * px; i += nthr) {
    float v = 1.f;
    if (use_life) {
      const int r = i / px, q = i % px;
      float m = at[r * ax + q];
#pragma unroll
      for (int k = 1; k < 9; ++k) m = fmaxf(m, at[(r + k / 3) * ax + q + k % 3]);
      v = m > athr ? 1.f : 0.f;
    }
    pre[i] = v;
  }
  __syncthreads();
}

// Stage the xg tile [C, hy, hx] at (y0, x0) by asynchronous copies: x
// into xg and goal into tmp (both zero outside the grid: the percept's
// padding), then xg = x + goal * pre in shared memory, pre the (hy x hx)
// mask tile. Ends with the block synchronised (and every asynchronous copy
// the block issued before it complete).
__device__ __forceinline__ void stage_xg_async(const float* xb, const float* gb,
                                               const float* pre, float* xg, float* tmp,
                                               int C, int hy, int hx, int y0, int x0, int H,
                                               int W, int tid, int nthr) {
  const int HW = H * W;
  for (int i = tid; i < C * hy * hx; i += nthr) {
    const int c = i / (hy * hx), rq = i % (hy * hx);
    const int gy = y0 + rq / hx, gx = x0 + rq % hx;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = (size_t)c * HW + gy * W + gx;
      cp_async4(xg + i, xb + o);
      cp_async4(tmp + i, gb + o);
    } else {
      xg[i] = tmp[i] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < C * hy * hx; i += nthr)
    xg[i] = __fadd_rn(xg[i], __fmul_rn(tmp[i], pre[i % (hy * hx)]));
  __syncthreads();
}

// Stage a [rp, ld] matrix by 16-byte asynchronous copies: entry (r, f) is
// src[r * nc + f] for r < nr and f < nc, zero elsewhere (plain stores). nc
// and ld are multiples of 4, dst and src 16-byte aligned (the launchers
// refuse weights that are not).
__device__ __forceinline__ void stage_mat_async(float* dst, const float* src, int rp, int ld,
                                                int nr, int nc, int tid, int nthr) {
  const int l4 = ld / 4, n4 = nc / 4;
  for (int i = tid; i < rp * l4; i += nthr) {
    const int r = i / l4, f4 = i - r * l4;
    float* d = dst + r * ld + 4 * f4;
    if (r < nr && f4 < n4)
      cp_async16(d, src + r * nc + 4 * f4);
    else
      d[0] = d[1] = d[2] = d[3] = 0.f;
  }
}

// The update's recompute on a 16 x 8 tile, the phases cnca_update and
// cnca_bwd_mlp share, so that the backward's relu and clamp gates are the
// forward's bits. Per-pixel columns have stride CB_LDM.
//
// The percept columns pc[(3c + s) * CB_LDM + pix] (rounded to bf16 with
// BF16), zeros for a pixel outside the grid; the pixel's two threads
// (half 0 and 1) take alternate channels.
template <bool BF16>
__device__ __forceinline__ void percept_cols(const float* xg, const float* wcs, float* pc,
                                             int C, bool valid, int pix, int half) {
  const int tx = pix & (CB_TX - 1), ty = pix >> 4;
  for (int c = half; c < C; c += 2) {
    float o[3] = {0.f, 0.f, 0.f};
    if (valid) percept3(xg + (c * CB_HY + ty) * CB_HX + tx, CB_HX, wcs + c * 27, o);
#pragma unroll
    for (int s = 0; s < 3; ++s) pc[(3 * c + s) * CB_LDM + pix] = rnd_if(BF16, o[s]);
  }
}

// One hidden layer: out[u] = relu(sum_k w[k][u] * in[k] + bias[u]) for the
// 8 units u0 .. u0 + 7 and the 4 pixels q0 + 32 i — FMA chains over k
// ascending from 0, then + bias (cnca_update's order), in[k] rounded to bf16
// on read with RND. A weight read (a broadcast float4) feeds 16 FMAs.
// Computed for u0 < nu, written (zeros past nu) for u0 < nw. w's rows are
// ldw floats apart, ldw >= u0 + 8.
template <bool RND>
__device__ __forceinline__ void relu_layer(const float* w, int ldw, const float* in, int nk,
                                           const float* bias, float* out, int u0, int nu,
                                           int nw, int q0) {
  float a[4][8] = {};
  if (u0 < nu) {
    for (int k = 0; k < nk; ++k) {
      const float4 wa = *reinterpret_cast<const float4*>(w + k * ldw + u0);
      const float4 wb = *reinterpret_cast<const float4*>(w + k * ldw + u0 + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = rnd_if(RND, in[k * CB_LDM + q0 + 32 * i]);
        a[i][0] = fmaf(wa.x, v, a[i][0]);
        a[i][1] = fmaf(wa.y, v, a[i][1]);
        a[i][2] = fmaf(wa.z, v, a[i][2]);
        a[i][3] = fmaf(wa.w, v, a[i][3]);
        a[i][4] = fmaf(wb.x, v, a[i][4]);
        a[i][5] = fmaf(wb.y, v, a[i][5]);
        a[i][6] = fmaf(wb.z, v, a[i][6]);
        a[i][7] = fmaf(wb.w, v, a[i][7]);
      }
    }
  }
  if (u0 < nw) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[(u0 + j) * CB_LDM + q0 + 32 * i] = fmaxf(a[i][j] + bias[u0 + j], 0.f);
    }
  }
}

// dx of the channels c0 .. c0 + 3 for the 4 pixels q0 + 32 i: FMA chains
// over e ascending from 0 (h2 rounded to bf16 on read with BF16); zeros for
// c0 >= C4. w3's rows are ld3 floats apart.
template <bool BF16>
__device__ __forceinline__ void dx_layer(const float* w3, int ld3, const float* h2, int D4,
                                         int c0, int C4, int q0, float dx[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dx[i][0] = dx[i][1] = dx[i][2] = dx[i][3] = 0.f;
  if (c0 >= C4) return;
  for (int e = 0; e < D4; ++e) {
    const float4 w = *reinterpret_cast<const float4*>(w3 + e * ld3 + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = rnd_if(BF16, h2[e * CB_LDM + q0 + 32 * i]);
      dx[i][0] = fmaf(w.x, v, dx[i][0]);
      dx[i][1] = fmaf(w.y, v, dx[i][1]);
      dx[i][2] = fmaf(w.z, v, dx[i][2]);
      dx[i][3] = fmaf(w.w, v, dx[i][3]);
    }
  }
}

// Floats of cnca_update's shared memory (below), and its two regions of
// per-pixel columns.
__host__ __device__ __forceinline__ int cu_cols_a(int C, int D8) {
  return (3 * C > D8 ? 3 * C : D8) * CB_LDM;
}
__host__ __device__ __forceinline__ int cu_cols_b(int C, int D8) {
  return D8 * CB_LDM > C * CB_HY * CB_HX ? D8 * CB_LDM : C * CB_HY * CB_HX;
}
__host__ __device__ __forceinline__ int cu_smem_floats(int C, int D4) {
  const int D8 = (D4 + 7) & ~7, C4 = (C + 3) & ~3;
  return 3 * C * D8 + D4 * D8 + D4 * C4 + 2 * D8 + ((C * 27 + 3) & ~3) + CB_AY * CB_AX +
         CB_HY * CB_HX + cu_cols_a(C, D8) + cu_cols_b(C, D8);
}

// Shared memory of cnca_update, float32, in this order (the float4-read
// weights first, D8 = D4 rounded up to 8, zero past D4):
//   w1s [P, D8]  w2s [D4, D8]  w3s [D4, C4]  b1s [D8]  b2s [D8]
//   wcs [C*27, rounded up to 4]  at [12, 20]  pre [10, 18]
//   ca  [max(P, D8), LDM]  the goal tile while xg is staged; the percept;
//                          then h2 (the percept is dead once h1 is done)
//   cb  [max(D8 * LDM, C*10*18)]  the xg tile until the percept is built;
//                          then h1 [D8, LDM]
// Only what the forward needs: 108.8 KB at C = 20, D = 64, two blocks an SM.
// The staging, the percept columns and the three layers are cnca_bwd_mlp's
// own device functions (stage_mat_async, stage_pre, stage_xg_async,
// percept_cols, relu_layer, dx_layer), so xn is the backward's recompute bit
// for bit.
template <bool BF16>
__global__ void __launch_bounds__(CB_THREADS, 2)
cnca_update_kernel(const float* __restrict__ x, const float* __restrict__ goal,
                   float* __restrict__ xn, const float* __restrict__ wcol,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, int C, int H, int W, int D4,
                   int alive, float athr, int use_life, uint32_t seed, uint32_t step,
                   uint32_t fthr) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 * C, C4 = (C + 3) & ~3, D8 = (D4 + 7) & ~7;
  float* w1s = smem;
  float* w2s = w1s + P * D8;
  float* w3s = w2s + D4 * D8;
  float* b1s = w3s + D4 * C4;
  float* b2s = b1s + D8;
  float* wcs = b2s + D8;
  float* at = wcs + ((C * 27 + 3) & ~3);
  float* pre = at + CB_AY * CB_AX;
  float* ca = pre + CB_HY * CB_HX;
  float* cb = ca + cu_cols_a(C, D8);

  const int tid = threadIdx.x;
  const int pix = tid & (CB_PIX - 1), half = tid >> 7;
  const int b = blockIdx.z;
  const int HW = H * W;
  stage_mat_async(w1s, w1, P, D8, P, D4, tid, CB_THREADS);
  stage_mat_async(w2s, w2, D4, D8, D4, D4, tid, CB_THREADS);
  stage_mat_async(w3s, w3, D4, C4, D4, C4, tid, CB_THREADS);
  stage_mat_async(b1s, b1, 1, D8, 1, D4, tid, CB_THREADS);
  stage_mat_async(b2s, b2, 1, D8, 1, D4, tid, CB_THREADS);
  for (int i = tid; i < C * 27; i += CB_THREADS) wcs[i] = wcol[i];
  const int y0 = blockIdx.y * CB_TY, x0 = blockIdx.x * CB_TX;
  const float* xb = x + (size_t)b * C * HW;
  stage_pre(xb + (size_t)alive * HW, at, pre, CB_AY, CB_AX, y0 - 2, x0 - 2, H, W, athr,
            use_life, tid, CB_THREADS);
  stage_xg_async(xb, goal + (size_t)b * C * HW, pre, cb, ca, C, CB_HY, CB_HX, y0 - 1, x0 - 1,
                 H, W, tid, CB_THREADS);
  // phase: staging (weights, pre, xg)
  const bool valid = x0 + (pix & (CB_TX - 1)) < W && y0 + (pix >> 4) < H;
  percept_cols<BF16>(cb, wcs, ca, C, valid, pix, half);
  __syncthreads();  // the percept
  const int q0 = tid & 31, ug = tid >> 5;
  relu_layer<false>(w1s, D8, ca, P, b1s, cb, 8 * ug, D4, D4, q0);
  __syncthreads();  // h1
  relu_layer<BF16>(w2s, D8, cb, D4, b2s, ca, 8 * ug, D4, D4, q0);
  __syncthreads();  // h2, over the percept
  // x at the thread's 4 pixels and channels, loaded before dx's chains
  const int c0 = 4 * ug;
  float xc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 32 * i;
    const int qx = x0 + (q & (CB_TX - 1)), qy = y0 + (q >> 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xc[i][j] = (qx < W && qy < H && c0 + j < C)
                     ? xb[(size_t)(c0 + j) * HW + qy * W + qx] : 0.f;
  }
  float dx[4][4];
  dx_layer<BF16>(w3s, C4, ca, D4, c0, C4, q0, dx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 32 * i;
    const int qx = x0 + (q & (CB_TX - 1)), qy = y0 + (q >> 4);
    if (qx >= W || qy >= H) continue;
    const int qpix = qy * W + qx;
    const bool on = (mask_bits(seed, (uint32_t)b, step, (uint32_t)qpix) >> 8) >= fthr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < C)
        xn[((size_t)b * C + c0 + j) * HW + qpix] = on ? __fadd_rn(xc[i][j], dx[i][j])
                                                      : xc[i][j];
    }
  }
  // phase: dx and the store
}

// cnca_gate: channels a block (20 channels: 5 groups, 320 blocks at 64^2
// b8)
#define CG_CG 4

// The 3 x 6 window of an alpha plane a [H, W] under a thread's 4 pixels (row
// py, columns px .. px + 3): rows py - 1 .. py + 1, columns px - 1 .. px + 4,
// -inf outside the grid (it takes no part in a max); the middle 4 of a row
// as one float4 where vec (W % 4 == 0, a 16-byte aligned) and all 4 lie in
// the grid.
__device__ __forceinline__ void alpha_window(float w[3][6], const float* __restrict__ a,
                                             int py, int px, int H, int W, bool vec) {
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    const int y = py - 1 + rr;
    const bool in = y >= 0 && y < H;
    const float* row = a + (size_t)(in ? y : 0) * W;
    w[rr][0] = in && px >= 1 ? row[px - 1] : -INFINITY;
    if (in && vec && px + 4 <= W) {
      const float4 v = *reinterpret_cast<const float4*>(row + px);
      w[rr][1] = v.x;
      w[rr][2] = v.y;
      w[rr][3] = v.z;
      w[rr][4] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[rr][1 + q] = in && px + q < W ? row[px + q] : -INFINITY;
    }
    w[rr][5] = in && px + 4 < W ? row[px + 4] : -INFINITY;
  }
}

// out = clamp(xn * life), life = pre & post, pre = maxpool3x3(x alpha) >
// thr and post = maxpool3x3(xn alpha) > thr. A block is a 32 x 16 tile
// (nca_common.cuh's SA_ geometry) of CG_CG channels of one batch item, a
// thread 4 pixels of a row. A thread issues all of its loads before it uses
// any: its channels of xn (a float4 a channel where vec: W % 4 == 0 and x,
// xn, out 16-byte aligned) and, with the living channel, its 3 x 6 windows
// of the alpha planes of x and xn (alpha_window; the neighbours' rows come
// from L1): one round trip to L2, no shared memory, no barrier. pre and
// post are an fmaxf over the in-bounds neighbours (the
// -inf outside takes no part: the reference's zero fill under thr > 0,
// pallas_cnca.py:23); the group of channel 0 writes life. out is
// __fmul_rn(xn, life), then fmaxf / fminf against the clamp. Bound by its
// bytes (xn and the alpha of x in, out and life out: 5.4 MB at 64^2 b8
// C 20, 1.6 us).
__global__ void __launch_bounds__(SA_THREADS)
cnca_gate_kernel(const float* __restrict__ x, const float* __restrict__ xn,
                 float* __restrict__ out, unsigned char* __restrict__ life, int C, int H,
                 int W, int alive, float athr, int use_life, float clampv, int vec) {
  const int tid = threadIdx.x;
  const int ng = (C + CG_CG - 1) / CG_CG;
  const int b = blockIdx.z / ng, c0 = (blockIdx.z - b * ng) * CG_CG;
  const int HW = H * W;
  // the thread's 4 pixels: tile row r, columns 4j .. 4j + 3
  const int j = tid % (SA_TW / 4), r = tid / (SA_TW / 4);
  const int py = blockIdx.y * SA_TH + r, px = blockIdx.x * SA_TW + 4 * j;
  const int n = py < H ? max(0, min(4, W - px)) : 0;
  if (n == 0) return;
  const size_t pix = (size_t)py * W + px;
  float v[CG_CG][4];
#pragma unroll
  for (int e = 0; e < CG_CG; ++e)
    load_px4(v[e], xn + ((size_t)b * C + c0 + e) * HW + pix, c0 + e < C ? n : 0, vec);
  float lf[4] = {1.f, 1.f, 1.f, 1.f};
  if (use_life) {
    float aw[3][6], nw[3][6];
    alpha_window(aw, x + ((size_t)b * C + alive) * HW, py, px, H, W, vec);
    alpha_window(nw, xn + ((size_t)b * C + alive) * HW, py, px, H, W, vec);
    // phase: the loads' issue
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dq = 0; dq < 3; ++dq) {
          m1 = fmaxf(m1, aw[dy][q + dq]);
          m2 = fmaxf(m2, nw[dy][q + dq]);
        }
      }
      const bool l = m1 > athr && m2 > athr;
      lf[q] = l ? 1.f : 0.f;
      if (c0 == 0 && life != nullptr && q < n) life[(size_t)b * HW + pix + q] = l ? 1 : 0;
    }
    // phase: the life mask (its wait for the loads included)
  }
#pragma unroll
  for (int e = 0; e < CG_CG; ++e) {
    if (c0 + e < C) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[e][q] = fminf(fmaxf(__fmul_rn(v[e][q], lf[q]), -clampv), clampv);
      store_px4(out + ((size_t)b * C + c0 + e) * HW + pix, v[e], n, vec);
    }
  }
  // phase: the gate and the store
}

static dim3 cnca_gate_grid(int B, int C, int H, int W) {
  return dim3((W + SA_TW - 1) / SA_TW, (H + SA_TH - 1) / SA_TH, B * ((C + CG_CG - 1) / CG_CG));
}

// Shared memory of cnca_bwd_mlp, float32, in this order:
//   w1s [PN, LDW]  w2s [DP, LDW]  w3s [DP, 36]  b1s [DP]  b2s [DP]
//   wcs [C*27, rounded up to 4]  at [12, 20]  pre [10, 18]  xg [C, 10, 18]
//   pc  [PN, LDM]    percept; row P all ones (db1); g_p at the end
//   hc1 [DP+8, LDM]  h1 (unrounded), then g_h1; row DP all ones (db2)
//   hc2 [DP, LDM]    h2 (unrounded), then g_h2
//   gd  [32, LDM]    g_dx, zero past C
// PN = P + 1 rounded up to 8, DP = D4 rounded up to 32, LDW = DP + 8
// (= 8 mod 32: the paired float2 weight reads are free of bank conflicts),
// LDM = 132 (= 4 mod 32: the fragment reads of the column arrays are);
// weights zero past their sizes.
template <bool BF16>
__global__ void __launch_bounds__(CB_THREADS, 1)
cnca_bwd_mlp_kernel(const float* __restrict__ x, const float* __restrict__ goal,
                    const unsigned char* __restrict__ life, float* __restrict__ g,
                    float* __restrict__ gp, float* __restrict__ slots,
                    const float* __restrict__ wcol, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3, int C,
                    int H, int W, int D4, int alive, float athr, int use_life,
                    float clampv, uint32_t seed, uint32_t step, uint32_t fthr) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 * C, C4 = (C + 3) & ~3;
  const int PN = (P + 8) & ~7, ntp = PN / 8;
  const int DP = (D4 + 31) & ~31, LDW = DP + 8, ntd = DP / 8;
  float* w1s = smem;
  float* w2s = w1s + PN * LDW;
  float* w3s = w2s + DP * LDW;
  float* b1s = w3s + DP * CB_LD3;
  float* b2s = b1s + DP;
  float* wcs = b2s + DP;
  float* at = wcs + ((C * 27 + 3) & ~3);
  float* pre = at + CB_AY * CB_AX;
  float* xg = pre + CB_HY * CB_HX;
  float* pc = xg + C * CB_HY * CB_HX;
  float* hc1 = pc + PN * CB_LDM;
  float* hc2 = hc1 + (DP + 8) * CB_LDM;
  float* gd = hc2 + DP * CB_LDM;

  const int tid = threadIdx.x;
  const int pix = tid & (CB_PIX - 1), half = tid >> 7;
  const int tx = pix & (CB_TX - 1), ty = pix >> 4;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int HW = H * W;
  // The weights by 16-byte asynchronous copies (zero padding by plain
  // stores), waited for with the xg tile's.
  stage_mat_async(w1s, w1, PN, LDW, P, D4, tid, CB_THREADS);
  stage_mat_async(w2s, w2, DP, LDW, D4, D4, tid, CB_THREADS);
  stage_mat_async(w3s, w3, DP, CB_LD3, D4, C4, tid, CB_THREADS);
  stage_mat_async(b1s, b1, 1, DP, 1, D4, tid, CB_THREADS);
  stage_mat_async(b2s, b2, 1, DP, 1, D4, tid, CB_THREADS);
  for (int i = tid; i < C * 27; i += CB_THREADS) wcs[i] = wcol[i];

  const int y0 = blockIdx.y * CB_TY, x0 = blockIdx.x * CB_TX;
  const float* xb = x + (size_t)b * C * HW;
  stage_pre(xb + (size_t)alive * HW, at, pre, CB_AY, CB_AX, y0 - 2, x0 - 2, H, W, athr,
            use_life, tid, CB_THREADS);
  // goal's tile passes through hc1/hc2, free until the recompute
  stage_xg_async(xb, goal + (size_t)b * C * HW, pre, xg, hc1, C, CB_HY, CB_HX, y0 - 1,
                 x0 - 1, H, W, tid, CB_THREADS);

  const int px = x0 + tx, py = y0 + ty;
  const bool valid = px < W && py < H;
  const int gpix = valid ? py * W + px : 0;

  // The forward's recompute through cnca_update's own device functions (so
  // the relu gates and xn are its bits), the two threads of a pixel taking
  // alternate channels, then halves of the hidden units. Percept column
  // (zeros past the grid's edge: such a pixel's g_dx is 0, so it adds
  // nothing to any gradient), the ones row and zero rows after it.
  percept_cols<BF16>(xg, wcs, pc, C, valid, pix, half);
  for (int r = P + half; r < PN; r += 2) pc[r * CB_LDM + pix] = (r == P && valid) ? 1.f : 0.f;
  for (int r = DP + half; r < DP + 8; r += 2)
    hc1[r * CB_LDM + pix] = (r == DP && valid) ? 1.f : 0.f;
  __syncthreads();  // the percept
  // h1, h2 and dx: a thread takes 8 hidden units (or 4 channels) for 4
  // pixels, 32 apart; rows past D4 up to DP are zeros (b1s and b2s are zero
  // there).
  const int q0 = tid & 31, ug = tid >> 5;
  relu_layer<false>(w1s, LDW, pc, P, b1s, hc1, 8 * ug, D4, DP, q0);
  __syncthreads();  // h1
  relu_layer<BF16>(w2s, LDW, hc1, D4, b2s, hc2, 8 * ug, D4, DP, q0);
  __syncthreads();  // h2
  // dx for channels 4 ug .. 4 ug + 3, then the clamp, life and mask
  // adjoints: g <- g_xn in place, g_dx column (zero past C).
  {
    const int c0 = 4 * ug;
    float dx[4][4];
    dx_layer<BF16>(w3s, CB_LD3, hc2, D4, c0, C4, q0, dx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 32 * i;
      const int qx = x0 + (q & (CB_TX - 1)), qy = y0 + (q >> 4);
      const bool qv = qx < W && qy < H;
      const int qpix = qv ? qy * W + qx : 0;
      const bool on =
          qv && (mask_bits(seed, (uint32_t)b, step, (uint32_t)qpix) >> 8) >= fthr;
      const float lf = (!use_life || (qv && life[(size_t)b * HW + qpix])) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        float gdx = 0.f;
        if (qv && c < C) {
          const size_t o = ((size_t)b * C + c) * HW + qpix;
          const float xc = x[o];
          const float xl = __fmul_rn(on ? __fadd_rn(xc, dx[i][j]) : xc, lf);
          const float in_range = (xl >= -clampv && xl <= clampv) ? 1.f : 0.f;
          const float gxn = __fmul_rn(__fmul_rn(g[o], in_range), lf);
          g[o] = gxn;
          gdx = on ? gxn : 0.f;
        }
        gd[c * CB_LDM + q] = rnd_if(BF16, gdx);
      }
    }
  }
  __syncthreads();  // g_dx

  // The backward products on the tensor cores. Each warp owns tile row
  // `warp` (16 pixels) for g_h2 = (W3 g_dx)[h2 > 0], g_h1 = (W2 g_h2)[h1 > 0]
  // and g_p = W1 g_h1 (M = pixels; each output's registers feed the next
  // product); the weight gradients sum over the block's 128 pixels in 16 x 8
  // output tiles, a warp taking a fixed run of the tiles that share a row
  // block of A (loaded and converted once for the run), each tile added once
  // into the block's slot.
  const int row0 = CB_TX * warp;
  const int nkc = (C + 15) / 16;  // depth blocks of 16 channels
  float acc[CB_NTD][4];
#pragma unroll
  for (int n = 0; n < CB_NTD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kb = 0; kb < nkc; ++kb) {
    float ga[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ga[2 * q] = gd[(16 * kb + t + 4 * q) * CB_LDM + row0 + gq];
      ga[2 * q + 1] = gd[(16 * kb + t + 4 * q) * CB_LDM + row0 + gq + 8];
    }
    FragA<BF16> fa;
    fa.strided(ga);
#pragma unroll
    for (int n = 0; n < CB_NTD; ++n) {
      if (n < ntd) {
        float bw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bw[q] = w3s[(8 * n + gq) * CB_LD3 + 16 * kb + t + 4 * q];
        mma_frag<BF16>(acc[n], fa, bw);
      }
    }
  }
  // gate by h2 > 0 (own pixels; hc2 still holds h2)
#pragma unroll
  for (int n = 0; n < CB_NTD; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (8 * n + 2 * t + (e & 1)) * CB_LDM + row0 + gq + 8 * (e >> 1);
      acc[n][e] = (n < ntd && hc2[o] > 0.f) ? rnd_if(BF16, acc[n][e]) : 0.f;
    }
  }
  const int slot_floats = C * 27 + P * D4 + 2 * D4 + D4 * D4 + D4 * C;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* sdwc = slots + (size_t)blk * slot_floats;
  float* sdw1 = sdwc + C * 27;  // [P, D4]
  float* sdb1 = sdw1 + P * D4;  // [D4]
  float* sdw2 = sdb1 + D4;      // [D4, D4]
  float* sdb2 = sdw2 + D4 * D4; // [D4]
  float* sdw3 = sdb2 + D4;      // [D4, C]

  // dW3 [e, c] = h2^T g_dx: the tiles (e 16, c 8) of a row of e share A;
  // warp w takes row w / 2, its first two tiles or the rest.
  {
    const int nct = (C + 7) / 8, mt = warp >> 1, nt0 = 2 * (warp & 1);
    const int n = (warp & 1) ? nct - 2 : min(2, nct);
    auto slot_at = [&](int j, int e) -> float* {
      const int r = 16 * mt + gq + 8 * (e >> 1), c = 8 * (nt0 + j) + 2 * t + (e & 1);
      return (j < n && r < D4 && c < C) ? sdw3 + r * C + c : nullptr;
    };
    float old[2][4] = {}, d[2][4] = {};
    if (16 * mt < DP && n > 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* p = slot_at(j, e);
          if (p != nullptr) old[j][e] = *p;
        }
      }
      mma_rows<BF16, 2, CB_PIX>(d, hc2 + 16 * mt * CB_LDM, gd + 8 * nt0 * CB_LDM, n, CB_LDM,
                                0, gq, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = slot_at(j, e);
          if (p != nullptr) *p = old[j][e] + d[j][e];
        }
      }
    }
  }
  __syncthreads();  // h2 is read for the last time
  // g_h2 into hc2; g_h1 = (W2 g_h2) gated by h1 > 0 (hc1 still holds h1).
  float acc1[CB_NTD][4];
#pragma unroll
  for (int n = 0; n < CB_NTD; ++n) {
    acc1[n][0] = acc1[n][1] = acc1[n][2] = acc1[n][3] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n < ntd)
        hc2[(8 * n + 2 * t + (e & 1)) * CB_LDM + row0 + gq + 8 * (e >> 1)] = acc[n][e];
  }
#pragma unroll
  for (int jj = 0; jj < CB_NTD / 2; ++jj) {
    if (2 * jj < ntd) {
      FragA<BF16> fa;
      fa.paired(acc[2 * jj], acc[2 * jj + 1]);
#pragma unroll
      for (int n = 0; n < CB_NTD; ++n) {
        if (n < ntd) {
          const float* wr = w2s + (8 * n + gq) * LDW + 16 * jj + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(wr);
          const float2 hi = *reinterpret_cast<const float2*>(wr + 8);
          const float bw[4] = {lo.x, lo.y, hi.x, hi.y};
          mma_frag<BF16>(acc1[n], fa, bw);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < CB_NTD; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (8 * n + 2 * t + (e & 1)) * CB_LDM + row0 + gq + 8 * (e >> 1);
      acc1[n][e] = (n < ntd && hc1[o] > 0.f) ? rnd_if(BF16, acc1[n][e]) : 0.f;
    }
  }
  __syncthreads();  // g_h2 is in hc2
  // dW2 [f, e] = h1^T g_h2 and db2 [e] (the ones row of hc1): tiles of
  // (g_h2 e 16) x (h1 f 8 | ones); warp w takes row w / 2 of e, its first
  // five tiles or the rest.
  {
    const int nft = ntd + 1, mt = warp >> 1, nt0 = 5 * (warp & 1);
    const int n = (warp & 1) ? nft - 5 : min(5, nft);
    auto slot_at = [&](int j, int e) -> float* {
      const int r = 16 * mt + gq + 8 * (e >> 1), f = 8 * (nt0 + j) + 2 * t + (e & 1);
      if (j >= n || r >= D4) return nullptr;
      return f < D4 ? sdw2 + f * D4 + r : f == DP ? sdb2 + r : nullptr;
    };
    float old[5][4] = {}, d[5][4] = {};
    if (16 * mt < DP && n > 0) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* p = slot_at(j, e);
          if (p != nullptr) old[j][e] = *p;
        }
      }
      mma_rows<BF16, 5, CB_PIX>(d, hc2 + 16 * mt * CB_LDM, hc1 + 8 * nt0 * CB_LDM, n, CB_LDM,
                                0, gq, t);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = slot_at(j, e);
          if (p != nullptr) *p = old[j][e] + d[j][e];
        }
      }
    }
  }
  __syncthreads();  // h1 is read for the last time
  // g_h1 into hc1 (the ones row stays); g_p = W1 g_h1.
  float gpa[CB_NTP][4];
#pragma unroll
  for (int n = 0; n < CB_NTP; ++n) gpa[n][0] = gpa[n][1] = gpa[n][2] = gpa[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < CB_NTD; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n < ntd)
        hc1[(8 * n + 2 * t + (e & 1)) * CB_LDM + row0 + gq + 8 * (e >> 1)] = acc1[n][e];
  }
#pragma unroll
  for (int jj = 0; jj < CB_NTD / 2; ++jj) {
    if (2 * jj < ntd) {
      FragA<BF16> fa;
      fa.paired(acc1[2 * jj], acc1[2 * jj + 1]);
#pragma unroll
      for (int n = 0; n < CB_NTP; ++n) {
        if (n < ntp) {
          const float* wr = w1s + (8 * n + gq) * LDW + 16 * jj + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(wr);
          const float2 hi = *reinterpret_cast<const float2*>(wr + 8);
          const float bw[4] = {lo.x, lo.y, hi.x, hi.y};
          mma_frag<BF16>(gpa[n], fa, bw);
        }
      }
    }
  }
  __syncthreads();  // g_h1 is in hc1
  // dW1 [k, f] = p^T g_h1 and db1 [f] (the ones row of pc): tiles of
  // (g_h1 f 16) x (p k 8 | ones); warp w takes row w / 2 of f, its first
  // five tiles or the rest.
  {
    const int mt = warp >> 1, nt0 = 5 * (warp & 1);
    const int n = (warp & 1) ? ntp - 5 : min(5, ntp);
    auto slot_at = [&](int j, int e) -> float* {
      const int f = 16 * mt + gq + 8 * (e >> 1), k = 8 * (nt0 + j) + 2 * t + (e & 1);
      if (j >= n || f >= D4) return nullptr;
      return k < P ? sdw1 + k * D4 + f : k == P ? sdb1 + f : nullptr;
    };
    float old[5][4] = {}, d[5][4] = {};
    if (16 * mt < DP && n > 0) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* p = slot_at(j, e);
          if (p != nullptr) old[j][e] = *p;
        }
      }
      mma_rows<BF16, 5, CB_PIX>(d, hc1 + 16 * mt * CB_LDM, pc + 8 * nt0 * CB_LDM, n, CB_LDM,
                                0, gq, t);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = slot_at(j, e);
          if (p != nullptr) *p = old[j][e] + d[j][e];
        }
      }
    }
  }
  __syncthreads();  // the percept is read for the last time
  // g_p into pc, then to gp by pixel.
#pragma unroll
  for (int n = 0; n < CB_NTP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n < ntp)
        pc[(8 * n + 2 * t + (e & 1)) * CB_LDM + row0 + gq + 8 * (e >> 1)] = gpa[n][e];
  }
  __syncthreads();  // g_p staged in pc
  if (valid)
    for (int k = half; k < P; k += 2) gp[((size_t)b * P + k) * HW + gpix] = pc[k * CB_LDM + pix];
  // dwcol [c, s*9 + di*3 + dj] += sum over the block's pixels of the xg tap
  // (di, dj) times g_p[c*3 + s], walking the tile's rows and columns (no
  // division a pixel).
  for (int o = tid; o < C * 27; o += CB_THREADS) {
    const int c = o / 27, k = o - 27 * c;
    const int s = k / 9, di = (k - 9 * s) / 3, dj = k - 9 * s - 3 * di;
    const float* tap = xg + (c * CB_HY + di) * CB_HX + dj;
    const float* gg = pc + (3 * c + s) * CB_LDM;
    float sum = 0.f;
    for (int r = 0; r < CB_TY; ++r) {
#pragma unroll
      for (int q = 0; q < CB_TX; ++q) sum = fmaf(tap[r * CB_HX + q], gg[r * CB_TX + q], sum);
    }
    sdwc[o] += sum;
  }
}

// cnca_bwd_adjoint: channels a block. Both channels' planes are staged at
// once, so the second's copies fly while the first's adjoint runs; the
// block's pre mask serves both.
#define CA_CG 2
// dynamic shared memory, floats: gp planes [CG][3][SA_PLANE], the alpha
// plane [SA_PLANE], the channels' weights [CG][27]
#define CA_SMEM_BYTES (sizeof(float) * ((CA_CG * 3 + 1) * SA_PLANE + CA_CG * 27))

// g += g_xg and dgoal += g_xg * pre, where g_xg is the adjoint of the
// depthwise percept: sum over (slot, kh, kw) of wcol * g_p shifted back.
// A block is a 32 x 16 tile (nca_common.cuh's SA_ geometry) of CA_CG
// channels of one batch item, a thread 4 pixels of a row: ceil(W/32) *
// ceil(H/16) * B * ceil(C/2) blocks (640 at 64^2 b8 C 20). Each channel's
// three slot planes of gp (contiguous: rows c*3 + s) are staged once by
// cp.async on the tile's 18 x 40 footprint (16-byte copies when vec: W % 4
// == 0 and x, gp, g and dgoal 16-byte aligned; 4-byte ones otherwise), zero
// outside the grid by plain stores, the padding resolved once a block in
// the thread's copy offsets. The alpha plane is staged once a block on the
// same footprint, -inf outside the grid, and pre = maxpool3x3(alpha) > thr
// taken from it with cnca_gate_kernel's fmaxf over the same in-bounds
// neighbours (the -inf fill takes no part), so the mask's bits are the
// gate's. g and dgoal come to registers, a float4 a thread where vec. The
// 27 terms are summed from term 0 in (slot, kh, kw) order, unfused, from
// 3x3 windows in registers: the first design's bits. Each thread reads and
// writes only its own pixels of g and dgoal: in place, no atomics.
__global__ void __launch_bounds__(SA_THREADS)
cnca_bwd_adjoint_kernel(const float* __restrict__ x, const float* __restrict__ gp,
                        const float* __restrict__ wcol, float* __restrict__ g,
                        float* __restrict__ dgoal, int C, int H, int W, int alive,
                        float athr, int use_life, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* apl = smem + CA_CG * 3 * SA_PLANE;  // the alpha plane
  float* ws = apl + SA_PLANE;                // the channels' 27 weights each
  const int tid = threadIdx.x;
  const int ng = (C + CA_CG - 1) / CA_CG;
  const int b = blockIdx.z / ng, c0 = (blockIdx.z - b * ng) * CA_CG;
  const int HW = H * W;
  const int y0 = blockIdx.y * SA_TH, x0 = blockIdx.x * SA_TW;
  const float* gpb = gp + (size_t)b * 3 * C * HW;
  int off[SA_SLOTS];
  plane_slots(off, y0, x0, H, W, false, vec, tid);
  if (use_life) stage_plane(apl, x + ((size_t)b * C + alive) * HW, off, -INFINITY, vec, tid);
#pragma unroll
  for (int e = 0; e < CA_CG; ++e) {
    if (c0 + e < C) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        stage_plane(smem + (e * 3 + s) * SA_PLANE, gpb + (size_t)(3 * (c0 + e) + s) * HW,
                    off, 0.f, vec, tid);
    }
    cp_async_commit();
  }
  if (tid < CA_CG * 27 && c0 * 27 + tid < C * 27) ws[tid] = wcol[c0 * 27 + tid];
  // the thread's 4 pixels: tile row r, columns 4j .. 4j + 3
  const int j = tid % (SA_TW / 4), r = tid / (SA_TW / 4);
  const int py = y0 + r, px = x0 + 4 * j;
  const int n = py < H ? max(0, min(4, W - px)) : 0;
  const size_t pix = (size_t)py * W + px;
  float gv[CA_CG][4], dv[CA_CG][4];
#pragma unroll
  for (int e = 0; e < CA_CG; ++e) {
    const int ne = c0 + e < C ? n : 0;
    const size_t at = ((size_t)b * C + c0 + e) * HW + pix;
    load_px4(gv[e], g + at, ne, vec);
    load_px4(dv[e], dgoal + at, ne, vec);
  }
  // phase: staging (the copy offsets, the copies' issue and the registers' loads)
  float pre[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int e = 0; e < CA_CG; ++e) {
    cp_async_wait_upto(CA_CG - 1 - e);
    __syncthreads();  // waiting: channel e's planes (and with the first, alpha) are in
    if (c0 + e < C && n > 0) {
      if (e == 0 && use_life) {
        float aw[3][6];
        plane_window(aw, apl, r, j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float m = -INFINITY;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dq = 0; dq < 3; ++dq) m = fmaxf(m, aw[dy][q + dq]);
          pre[q] = m > athr ? 1.f : 0.f;
        }
      }
      const float* wc = ws + e * 27;
      float acc[4] = {};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        float w[3][6];
        plane_window(w, smem + (e * 3 + s) * SA_PLANE, r, j);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int di = k / 3, dj = k % 3;
          const float wk = wc[s * 9 + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float term = __fmul_rn(w[2 - di][q + 2 - dj], wk);
            acc[q] = s == 0 && k == 0 ? term : __fadd_rn(acc[q], term);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gv[e][q] = __fadd_rn(gv[e][q], acc[q]);
        dv[e][q] = __fadd_rn(dv[e][q], __fmul_rn(acc[q], pre[q]));
      }
      // phase: adjoint
      const size_t at = ((size_t)b * C + c0 + e) * HW + pix;
      store_px4(g + at, gv[e], n, vec);
      store_px4(dgoal + at, dv[e], n, vec);
    }
    // phase: store
  }
}

static dim3 cnca_adjoint_grid(int B, int C, int H, int W) {
  return dim3((W + SA_TW - 1) / SA_TW, (H + SA_TH - 1) / SA_TH, B * ((C + CA_CG - 1) / CA_CG));
}

static bool bad_sizes(int C, int D4) {
  return C < 1 || C > CNCA_C_MAX || D4 < 4 || D4 > CNCA_D_MAX || D4 % 4 != 0;
}

// The weights go to shared memory by 16-byte copies.
static bool unaligned(const float* w1, const float* b1, const float* w2, const float* b2,
                      const float* w3) {
  const float* ps[] = {w1, b1, w2, b2, w3};
  for (const float* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

extern "C" {

// Sizes past these limits are refused by the wrapper before launch.
int cnca_limits(int* c_max, int* d_max) {
  *c_max = CNCA_C_MAX;
  *d_max = CNCA_D_MAX;
  return 0;
}

// One step's update: x [B, C, H, W] -> xn (distinct buffers), goal as x.
// wcol [C, 27], w1 [3C, D4], b1 [D4], w2 [D4, D4], b2 [D4], w3 [D4, C4],
// float32. Returns the launch's cudaGetLastError().
int cnca_update_launch(const float* x, const float* goal, float* xn, const float* wcol,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* w3, int B, int C, int H, int W,
                       int D4, int alive, float athr, int use_life, int bf16,
                       unsigned int seed, unsigned int step, unsigned int fthr,
                       void* stream) {
  if (bad_sizes(C, D4) || alive < 0 || alive >= C || unaligned(w1, b1, w2, b2, w3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)cu_smem_floats(C, D4);
  const dim3 grid((W + CB_TX - 1) / CB_TX, (H + CB_TY - 1) / CB_TY, B);
  const dim3 block(CB_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(cnca_update_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cnca_update_kernel<true><<<grid, block, smem, s>>>(
        x, goal, xn, wcol, w1, b1, w2, b2, w3, C, H, W, D4, alive, athr, use_life, seed,
        step, fthr);
  } else {
    cudaFuncSetAttribute(cnca_update_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cnca_update_kernel<false><<<grid, block, smem, s>>>(
        x, goal, xn, wcol, w1, b1, w2, b2, w3, C, H, W, D4, alive, athr, use_life, seed,
        step, fthr);
  }
  return (int)cudaGetLastError();
}

// Blocks an SM of cnca_update at these widths (cudaOccupancy...), with its
// dynamic shared memory in *smem_bytes.
int cnca_update_occupancy(int C, int D4, int bf16, int* blocks, int* smem_bytes) {
  if (bad_sizes(C, D4)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)cu_smem_floats(C, D4);
  *smem_bytes = (int)smem;
  if (bf16) {
    cudaFuncSetAttribute(cnca_update_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cnca_update_kernel<true>,
                                                  CB_THREADS, smem);
  } else {
    cudaFuncSetAttribute(cnca_update_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cnca_update_kernel<false>,
                                                  CB_THREADS, smem);
  }
  return (int)cudaGetLastError();
}

// One step's gate: out = clamp(xn * life), life = alive(x) & alive(xn)
// written to life [B, H, W] unless it is null. Returns cudaGetLastError().
int cnca_gate_launch(const float* x, const float* xn, float* out, unsigned char* life,
                     int B, int C, int H, int W, int alive, float athr, int use_life,
                     float clampv, void* stream) {
  const dim3 grid = cnca_gate_grid(B, C, H, W);
  if (C < 1 || C > CNCA_C_MAX || alive < 0 || alive >= C || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = W % 4 == 0 && a16(x) && a16(xn) && a16(out);
  cnca_gate_kernel<<<grid, SA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, xn, out, life, C, H, W, alive, athr, use_life, clampv, vec);
  return (int)cudaGetLastError();
}

// cnca_gate's launch at [B, C, H, W]: its blocks in *n_blocks, blocks an SM
// (cudaOccupancy...) in *blocks, its shared memory (none) in *smem_bytes.
int cnca_gate_geometry(int B, int C, int H, int W, int* n_blocks, int* blocks,
                       int* smem_bytes) {
  const dim3 grid = cnca_gate_grid(B, C, H, W);
  *n_blocks = (int)(grid.x * grid.y * grid.z);
  *smem_bytes = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cnca_gate_kernel, SA_THREADS, 0);
  return (int)cudaGetLastError();
}

// One reverse step's first pass. x the step's input, goal as x, life its
// life mask [B, H, W] (ignored without the living channel), g the cotangent
// of its output, overwritten with g_xn. Writes gp [B, 3C, H, W] and adds into
// slots [n_blocks, S], n_blocks = ceil(W/16) * ceil(H/8) * B, S = C*27 +
// 3C*D4 + D4 + D4*D4 + D4 + D4*C (dwcol | dW1 | db1 | dW2 | db2 | dW3).
// Returns cudaGetLastError().
int cnca_bwd_mlp_launch(const float* x, const float* goal, const unsigned char* life,
                        float* g, float* gp, float* slots, const float* wcol,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, const float* w3, int B, int C, int H, int W,
                        int D4, int alive, float athr, int use_life, float clampv,
                        int bf16, unsigned int seed, unsigned int step,
                        unsigned int fthr, void* stream) {
  if (bad_sizes(C, D4) || alive < 0 || alive >= C || unaligned(w1, b1, w2, b2, w3))
    return (int)cudaErrorInvalidValue;
  const int P = 3 * C, PN = (P + 8) & ~7, DP = (D4 + 31) & ~31, LDW = DP + 8;
  const size_t smem =
      sizeof(float) * ((size_t)PN * LDW + (size_t)DP * LDW + (size_t)DP * CB_LD3 + 2 * DP +
                       ((C * 27 + 3) & ~3) + CB_AY * CB_AX + CB_HY * CB_HX +
                       (size_t)C * CB_HY * CB_HX + (size_t)(PN + 2 * DP + 8 + CB_KC) * CB_LDM);
  const dim3 grid((W + CB_TX - 1) / CB_TX, (H + CB_TY - 1) / CB_TY, B);
  const dim3 block(CB_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(cnca_bwd_mlp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cnca_bwd_mlp_kernel<true><<<grid, block, smem, s>>>(
        x, goal, life, g, gp, slots, wcol, w1, b1, w2, b2, w3, C, H, W, D4, alive, athr,
        use_life, clampv, seed, step, fthr);
  } else {
    cudaFuncSetAttribute(cnca_bwd_mlp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cnca_bwd_mlp_kernel<false><<<grid, block, smem, s>>>(
        x, goal, life, g, gp, slots, wcol, w1, b1, w2, b2, w3, C, H, W, D4, alive, athr,
        use_life, clampv, seed, step, fthr);
  }
  return (int)cudaGetLastError();
}

// One reverse step's second pass: g += g_xg and dgoal += g_xg * pre, in
// place, where g_xg is the depthwise adjoint of gp [B, 3C, H, W] and pre the
// alive mask of x. Returns cudaGetLastError().
int cnca_bwd_adjoint_launch(const float* x, const float* gp, const float* wcol, float* g,
                            float* dgoal, int B, int C, int H, int W, int alive,
                            float athr, int use_life, void* stream) {
  const dim3 grid = cnca_adjoint_grid(B, C, H, W);
  if (C < 1 || C > CNCA_C_MAX || alive < 0 || alive >= C || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  const auto a16 = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = W % 4 == 0 && a16(x) && a16(gp) && a16(g) && a16(dgoal);
  cnca_bwd_adjoint_kernel<<<grid, SA_THREADS, CA_SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      x, gp, wcol, g, dgoal, C, H, W, alive, athr, use_life, vec);
  return (int)cudaGetLastError();
}

// cnca_bwd_adjoint's launch at [B, C, H, W]: its blocks in *n_blocks, blocks
// an SM (cudaOccupancy...) in *blocks, its dynamic shared memory in
// *smem_bytes.
int cnca_bwd_adjoint_geometry(int B, int C, int H, int W, int* n_blocks, int* blocks,
                              int* smem_bytes) {
  const dim3 grid = cnca_adjoint_grid(B, C, H, W);
  *n_blocks = (int)(grid.x * grid.y * grid.z);
  *smem_bytes = (int)CA_SMEM_BYTES;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cnca_bwd_adjoint_kernel, SA_THREADS,
                                                CA_SMEM_BYTES);
  return (int)cudaGetLastError();
}

}  // extern "C"
