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
//     filters under circular wrap (_flip :68), read from a staged footprint
//     of gp. Each thread reads and writes only its own pixels of gx, so it
//     updates gx in place; launched after nca_bwd_mlp on the same stream,
//     which has read gx by then.
// Scales (0, 1): nca_bwd_mlp's MS form recomputes the averaged percept
// through nca_step's own device functions (nca_common.cuh::half_percept,
// ms_average), so the percept and the relu gates agree with the forward,
// and its gp is the cotangent of the average. nca_bwd_adjoint_ms is the
// transpose of down -> half-res stencils -> clamped up, plus the scale-0
// stencils, averaged 0.5 — in gather form: each block forms U^T gp over W,
// then H, on its 10 x 10 half-pixel footprint from gp staged in shared
// memory, the half-resolution stencil adjoint (circular at half resolution)
// on its 8 x 8 half pixels, and adds 0.5 * (scale-0 adjoint + 0.25 *
// parent's g_h) (D^T of the 2x2 mean) to each of its pixels. No atomics and
// no scratch buffer.
// Frame taps: a tap at state t (the input of step t) adds its cotangent in
// the adjoint launch of step t, right after gx has become the cotangent of
// that state (an optional gtap pointer of both adjoint kernels), so one
// reverse walk serves a whole tapped schedule.
//
// What bounds it on an H100: per pixel and step nca_bwd_mlp does the
// forward's first layer again (z1 = W1^T p, P*F multiply-adds; the second
// layer is not recomputed) plus W2 gdx (F*C), W1 gz1 (P*F) and the weight-gradient
// products summed over pixels (P*F + F*C): 2*(3*P*F + 2*F*C) FLOP, 33.4
// kFLOP at c12/fc96/pos_emb, 55.8 k at c16/fc128/pos_emb, against ~32 C*4 +
// cc*4 bytes of state, cond, gx and gp: arithmetic bounds it.
//
// What the design does about it: every product runs on the tensor cores as
// warp-level mma.sync (nca_mma.cuh; float32 compute in split TF32, bf16
// compute in bf16, float32 accumulators). The recompute of z1 goes through
// the rollout step's own z1 function (z1_mma, z1_finish): the product, then
// a certificate that recomputes, as the forward's FMA chain, every element
// whose relu input lies within the product's error bound of zero, so the
// gates are the forward's bits. A block is a 16 x 16 tile of 256 pixels and
// 512 threads (16 warps, as many as two 256-thread blocks; its ~223 KB of
// shared memory at c16/fc128/cc2 allows one block an SM). Two threads a pixel build the percept and the gdx columns in shared
// memory (stride 260 floats, so every fragment read is free of bank
// conflicts); the weights and the state tile arrive by cp.async. Then, a
// chunk of 32 hidden units at a time: each warp forms z1 for its 16 pixels
// x 32 units and writes hid; forms W2 gdx (M = pixels, K = channels), gates
// it into gz1 in registers and feeds those registers straight into gp += W1
// gz1 (M = pixels, K = units, N = percept rows; gp accumulates in registers
// over the chunks); then the block's dW1^T = gz1^T [p | 1] and dW2^T = hid^T
// gdx (depth = the 256 pixels) go to the warps as groups of 16 x 8 output
// tiles that share their A rows, each group summed by two warps over half
// the pixels and added once into the block's slot (db1 is the ones row of
// the percept; db2 a warp reduction). No atomics: every block owns the same
// pixels and slot every step and sums in a fixed order, so two launches
// give the same bits. A clock64 profile of the block at 256^2 b3 c16/fc128
// (PERF.md §6) put a quarter of its time in the z1 recompute, a third in
// the weight-gradient products and a sixth each in W2 gdx + W1 gz1 and the
// percept.
// The multiscale adjoint moves 6C floats a pixel (gp in, gx in and out), so
// bytes bound it (0.0225 ms at 256^2 b3 c16). So that latency does not, it
// stages each channel's footprint once by cp.async (16-byte copies where
// the rows are aligned), double-buffered across passes of ADJ_CP = 2
// channels, and computes every phase from shared memory (about 53 KB a
// block: four blocks an SM); see nca_bwd_adjoint_ms_kernel.
// The single-scale adjoint moves 6C floats a pixel too (0.0056 ms at 128^2
// b4 c12). It spreads channel pairs over the grid (768 blocks at that
// shape) and stages each channel's planes once by cp.async; see
// nca_bwd_adjoint_kernel.
//
// bf16 mode rounds where the TPU kernel casts to its compute dtype
// (:1232-1238): the percept (with the conditioning rows), hid, gdx and gz1;
// W1 and W2 come rounded from the wrapper's packing. Accumulation, gp and
// the adjoint stay float32.

#include "nca_common.cuh"
#include "nca_mma.cuh"

#define NT_THREADS (NCA_TILE * NCA_TILE)  // pixels of a block
#define NB_THREADS (2 * NT_THREADS)       // nca_bwd_mlp: two threads a pixel
#define NB_FC 32                          // hidden units a chunk
#define NB_LDM (NT_THREADS + 4)           // stride of the per-pixel columns
#define NB_LDW2 20                        // stride of W2's rows in shared memory
#define NB_NTP ((4 * NCA_C_MAX + NCA_CC_MAX + 8) / 8)  // 8-wide tiles of [p | 1]
#define NB_RED (8 * 3 * 4 * 32)  // floats of the weight-gradient exchange

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

// Shared memory of nca_bwd_mlp, float32, in this order:
//   w1s [PN, LDW]  W1, rows in the percept's block order, zero past P and F4
//   w2s [FP, 20]   W2 (unit-major), zero past F4 and C
//   b1s [FP]
//   w1n [FP]       sum_k |W1[k][u]| (z1's certificate, nca_mma.cuh)
//   ps  [PN, LDM]  percept columns, one per pixel; row P all ones (db1 rides
//                  in dW1's product), rows past it zero; gp at the end
//   gds [16, LDM]  gdx columns, zero past C
//   hs  [FC, LDM]  hid of the current chunk of hidden units (unrounded)
//   gzs [FC, LDM]  gz1 of the current chunk
//   red [8, 3, 4, 32]  the second pixel half's sums of the weight-gradient
//                  tiles
//   pmx [2, 256]   max |p| of each pixel over the rows each of its two
//                  threads built (z1's certificate)
// The C x 18 x 18 state tile (and with MS the half-state tile and the half
// percept, nca_common.cuh::half_percept) lives in hs/gzs until the percept
// is built. PN = P + 1 rounded up to 8, FP = F4 rounded up to FC,
// LDW = FP + 8 (= 8 mod 32: the paired float2 reads of W1 for gp are free of
// bank conflicts), LDM = 260 (= 4 mod 32: every fragment read of a column
// array, depth = pixels or channels, is free of bank conflicts).
template <bool BF16, bool MS>
__global__ void __launch_bounds__(NB_THREADS, 1)
nca_bwd_mlp_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                   const float* __restrict__ gx, float* __restrict__ gp,
                   float* __restrict__ dcond, float* __restrict__ slots,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, int C, int H, int W, int cc,
                   int F4, uint32_t seed, uint32_t step, uint32_t thr) {
  extern __shared__ __align__(16) float smem[];
  const int P = 4 * C + cc;
  const int PN = (P + 8) & ~7, ntp = PN / 8;
  const int FP = (F4 + NB_FC - 1) / NB_FC * NB_FC, LDW = FP + 8;
  float* w1s = smem;
  float* w2s = w1s + PN * LDW;
  float* b1s = w2s + FP * NB_LDW2;
  float* w1n = b1s + FP;
  float* ps = w1n + FP;
  float* gds = ps + PN * NB_LDM;
  float* hs = gds + NCA_C_MAX * NB_LDM;
  float* gzs = hs + NB_FC * NB_LDM;
  float* red = gzs + NB_FC * NB_LDM;
  float* pmx = red + NB_RED;
  float* tile = hs;
  float* htile = tile + C * NCA_HALO * NCA_HALO;
  float* hp = htile + C * NCA_HHALO * NCA_HHALO;

  const int tid = threadIdx.x;
  const int pix = tid & (NT_THREADS - 1), half = tid >> 8;
  const int tx = pix & (NCA_TILE - 1), ty = pix >> 4;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int HW = H * W;

  // The weights by cp.async (W1's rows 16 bytes at a time: F4 and LDW are
  // multiples of 4; W2 and b1 4 bytes at a time), the zero padding by plain
  // stores; all distinct addresses. Waited for with the state tile's copies.
  const int q4 = F4 / 4;
  for (int i = tid; i < P * q4; i += NB_THREADS) {
    const int r = i / q4, q = i - r * q4;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(w1s + r * LDW + 4 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(w1 + (size_t)r * F4 + 4 * q));
  }
  for (int i = tid; i < PN * LDW; i += NB_THREADS) {
    const int r = i / LDW, f = i - r * LDW;
    if (r >= P || f >= F4) w1s[i] = 0.f;
  }
  for (int i = tid; i < FP * NB_LDW2; i += NB_THREADS) {
    const int f = i / NB_LDW2, c = i - f * NB_LDW2;
    if (f < F4 && c < C)
      cp_async4(w2s + i, w2 + f * C + c);
    else
      w2s[i] = 0.f;
  }
  for (int i = tid; i < FP; i += NB_THREADS) {
    if (i < F4)
      cp_async4(b1s + i, b1 + i);
    else
      b1s[i] = 0.f;
  }

  // The forward's percept, through the forward's own device functions
  // (circular padding), so z1 and the relu gates agree bit for bit.
  const float* xb = x + (size_t)b * C * HW;
  stage_tile_async(tile, xb, C, H, W, blockIdx.y * NCA_TILE - 1,
                   blockIdx.x * NCA_TILE - 1, 0, tid, NB_THREADS);
  if (MS)  // its loads overlap the tile's copies
    half_percept(htile, hp, xb, C, H, W, blockIdx.y, blockIdx.x, 0, tid,
                 NB_THREADS);
  cp_async_wait_all();
  __syncthreads();  // the weights, the state tile and the half percept

  const int px = blockIdx.x * NCA_TILE + tx;
  const int py = blockIdx.y * NCA_TILE + ty;
  const bool valid = px < W && py < H;
  const int gpix = valid ? py * W + px : 0;
  int fi = 0, fin = 0, fj = 0, fjn = 0;
  if (MS && valid) {
    upsample_taps(blockIdx.y, ty, H, fi, fin);
    upsample_taps(blockIdx.x, tx, W, fj, fjn);
  }
  const int nf = NCA_HFOOT * NCA_HFOOT;

  // Percept and gdx columns, the two threads of a pixel taking alternate
  // channels. A pixel past the grid's edge gets zeros, which add nothing to
  // any gradient (its gdx is 0, so is its gz1).
  float pm = 0.f;  // max |p| over this thread's percept rows (certificate)
  for (int c = half; c < C; c += 2) {
    float v = 0.f, sx = 0.f, sy = 0.f, lap = 0.f;
    if (valid) {
      const float* tp = tile + (c * NCA_HALO + ty) * NCA_HALO + tx;
      stencils(tp, sx, sy, lap);
      v = tp[NCA_HALO + 1];
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
    ps[c * NB_LDM + pix] = v;
    ps[(C + c) * NB_LDM + pix] = sx;
    ps[(2 * C + c) * NB_LDM + pix] = sy;
    ps[(3 * C + c) * NB_LDM + pix] = lap;
    pm = fmaxf(fmaxf(pm, fmaxf(fabsf(v), fabsf(sx))), fmaxf(fabsf(sy), fabsf(lap)));
  }
  for (int j = half; j < cc; j += 2) {
    float v = valid ? cond[((size_t)b * cc + j) * HW + gpix] : 0.f;
    v = BF16 ? bf16_round(v) : v;
    ps[(4 * C + j) * NB_LDM + pix] = v;
    pm = fmaxf(pm, fabsf(v));
  }
  pmx[half * NT_THREADS + pix] = pm;
  z1_norms(w1n, w1s, LDW, P, FP, tid, NB_THREADS);
  for (int r = P + half; r < PN; r += 2)
    ps[r * NB_LDM + pix] = (r == P && valid) ? 1.f : 0.f;
  const bool on =
      valid && (mask_bits(seed, (uint32_t)b, step, (uint32_t)gpix) >> 8) >= thr;
  for (int c = half; c < NCA_C_MAX; c += 2) {
    const float gv = (on && c < C) ? gx[((size_t)b * C + c) * HW + gpix] : 0.f;
    gds[c * NB_LDM + pix] = BF16 ? bf16_round(gv) : gv;
  }
  __syncthreads();  // the state tile is dead: hs/gzs take its memory

  // This warp's 16 pixels (tile row `warp`) as the A operand of W2 gdx,
  // the channels in the strided map.
  const int row0 = NCA_TILE * warp;
  const Cols cols{ps, NB_LDM, 0};
  float ga[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ga[2 * q] = gds[(t + 4 * q) * NB_LDM + row0 + g];
    ga[2 * q + 1] = gds[(t + 4 * q) * NB_LDM + row0 + g + 8];
  }
  FragA<BF16> gfa;
  gfa.strided(ga);
  float gpa[NB_NTP][4];
#pragma unroll
  for (int n = 0; n < NB_NTP; ++n) gpa[n][0] = gpa[n][1] = gpa[n][2] = gpa[n][3] = 0.f;

  const size_t slot_floats = (size_t)P * F4 + F4 + (size_t)F4 * C + C;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* sdw1 = slots + blk * slot_floats;  // [P, F4]
  float* sdb1 = sdw1 + P * F4;              // [F4]
  float* sdw2 = sdb1 + F4;                  // [F4, C]
  float* sdb2 = sdw2 + F4 * C;              // [C]

  for (int f0 = 0; f0 < FP; f0 += NB_FC) {
    // z1 + b1 for this warp's 16 pixels x the chunk's 32 units through the
    // rollout step's own z1 function (nca_mma.cuh: the tensor-core product
    // and the near-zero certificate), so every relu gate is the forward's;
    // hid to hs, unrounded (bf16 rounds it as an operand).
    float z[1][NB_FC / 8][4];
    z1_mma<BF16, 1, NB_FC / 8>(z, cols, w1s, LDW, P, row0, f0, g, t);
    z1_finish<1, NB_FC / 8>(z, cols, w1s, LDW, b1s, w1n, pmx, pmx + NT_THREADS, P, row0,
                            f0, g, t);
#pragma unroll
    for (int j = 0; j < NB_FC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hs[(8 * j + 2 * t + (e & 1)) * NB_LDM + row0 + g + 8 * (e >> 1)] =
            fmaxf(z[0][j][e], 0.f);
    }
    __syncthreads();  // hid of the chunk

    // g2 = W2 gdx on this warp's 16 pixels x 32 units (tensor cores), gated
    // by z1 > 0 (hid > 0) into gz1, which goes to gzs and, from registers,
    // into gp += W1 gz1.
    float gz[NB_FC / 8][4];
#pragma unroll
    for (int j = 0; j < NB_FC / 8; ++j) {
      gz[j][0] = gz[j][1] = gz[j][2] = gz[j][3] = 0.f;
      float bw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) bw[q] = w2s[(f0 + 8 * j + g) * NB_LDW2 + t + 4 * q];
      mma_frag<BF16>(gz[j], gfa, bw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (8 * j + 2 * t + (e & 1)) * NB_LDM + row0 + g + 8 * (e >> 1);
        float v = z[0][j][e] > 0.f ? gz[j][e] : 0.f;
        if (BF16) v = bf16_round(v);
        gz[j][e] = v;
        gzs[o] = v;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NB_FC / 16; ++jj) {
      const int u = f0 + 16 * jj + 2 * t;
      FragA<BF16> fz;
      fz.paired(gz[2 * jj], gz[2 * jj + 1]);
#pragma unroll
      for (int n = 0; n < NB_NTP; ++n) {
        if (n < ntp) {
          const float* wr = w1s + (8 * n + g) * LDW + u;
          const float2 lo = *reinterpret_cast<const float2*>(wr);
          const float2 hi = *reinterpret_cast<const float2*>(wr + 8);
          const float bw[4] = {lo.x, lo.y, hi.x, hi.y};
          mma_frag<BF16>(gpa[n], fz, bw);
        }
      }
    }
    __syncthreads();  // gz1 of the chunk; W2 gdx and W1 gz1 done

    // The block's sums over its 256 pixels (tensor cores, depth = pixels in
    // the strided map): dW1^T [units x (P | ones)] = gz1^T [p | 1] (db1 in
    // column P) and dW2^T [units x C] = hid^T gdx, in 16 x 8 output tiles.
    // Eight groups of up to three tiles that share their A rows (dW1: units
    // mt x percept tiles 3 ng .. 3 ng + 2; dW2: units mt x both channel
    // tiles), each summed by two warps over one half of the pixels; the
    // second half's sums reach the first through red, which adds them and
    // adds the tile once into the block's slot.
    {
      const int gi = warp >> 1, kh = warp & 1;
      const bool is_w1 = gi < 6;
      const int mt = is_w1 ? gi / 3 : gi - 6;
      const int nt0 = is_w1 ? 3 * (gi % 3) : 0;
      const int n = is_w1 ? min(3, ntp - nt0) : 2;
      // the slot entry of output (j, e) of this group, or null
      auto slot_at = [&](int j, int e) -> float* {
        const int f = f0 + 16 * mt + g + 8 * (e >> 1);
        const int nn = 8 * (nt0 + j) + 2 * t + (e & 1);
        if (j >= n || f >= F4) return nullptr;
        if (is_w1) return nn < P ? sdw1 + nn * F4 + f : nn == P ? sdb1 + f : nullptr;
        return nn < C ? sdw2 + f * C + nn : nullptr;
      };
      // the first half's warps read their slot entries before the products,
      // so that the reads' latency hides behind them
      float old[3][4] = {};
      if (kh == 0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* p = slot_at(j, e);
            if (p != nullptr) old[j][e] = *p;
          }
        }
      }
      float acc[3][4] = {};
      if (n > 0)
        mma_rows<BF16, 3, NT_THREADS / 2>(acc, (is_w1 ? gzs : hs) + 16 * mt * NB_LDM,
                                          (is_w1 ? ps : gds) + 8 * nt0 * NB_LDM, n,
                                          NB_LDM, kh * (NT_THREADS / 2), g, t);
      float* rw = red + gi * (3 * 4 * 32) + lane;
      if (kh == 1) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) rw[(4 * j + e) * 32] = acc[j][e];
        }
      }
      __syncthreads();  // the second pixel half's sums are in red
      if (kh == 0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* p = slot_at(j, e);
            if (p != nullptr) *p = old[j][e] + (acc[j][e] + rw[(4 * j + e) * 32]);
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites hs/gzs
  }

  // db2: one warp a channel, lanes over pixels in a fixed order.
  if (warp < C) {
    float s = 0.f;
    for (int i = lane; i < NT_THREADS; i += 32) s += gds[warp * NB_LDM + i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) sdb2[warp] += s;
  }
  // gp through ps (every read of the percept is done), then out by pixel.
#pragma unroll
  for (int n = 0; n < NB_NTP; ++n) {
    if (n < ntp) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ps[(8 * n + 2 * t + (e & 1)) * NB_LDM + row0 + g + 8 * (e >> 1)] = gpa[n][e];
    }
  }
  __syncthreads();  // gp staged in ps
  if (!valid) return;
  float* gpb = gp + (size_t)b * 4 * C * HW + gpix;
  for (int k = half; k < 4 * C; k += 2) gpb[(size_t)k * HW] = ps[k * NB_LDM + pix];
  if (dcond != nullptr) {
    for (int j = half; j < cc; j += 2)
      dcond[((size_t)b * cc + j) * HW + gpix] += ps[(4 * C + j) * NB_LDM + pix];
  }
}

// nca_bwd_adjoint: channels a block. Both channels' planes are staged at
// once, so the second's copies fly while the first's adjoint runs.
#define ADJ1_CG 2
#define ADJ1_SMEM_BYTES (sizeof(float) * ADJ1_CG * 3 * SA_PLANE)

// gx [B, C, H, W] += gp[:, :C] + adjoint stencils of gp[:, C:4C], circular;
// then, when gtap is not null, += gtap [B, C, H, W] (a frame tap's
// cotangent: gx has just become the cotangent of the state it taps).
// A block is a 32 x 16 tile (nca_common.cuh's SA_ geometry) of ADJ1_CG
// channels of one batch item, a thread 4 pixels of a row, so the grid holds
// ceil(W/32) * ceil(H/16) * B * ceil(C/2) blocks (768 at 128^2 b4 C 12).
// Each channel's three stencil planes of gp are staged once by cp.async on
// the tile's 18 x 40 footprint (16-byte copies when vec: W % 4 == 0 and gp,
// gx and gtap 16-byte aligned; 4-byte ones otherwise), the circular wrap
// resolved once a block in the thread's copy offsets; its raw plane, gx and
// gtap come straight to registers, a float4 a thread where vec. The adjoint
// of a pixel is stencil_adjoint on its 3x3 windows (registers, from three
// loads a staged row), in the first design's term order, so the result is
// that design's bit for bit. Each thread reads and writes only its own
// pixels of gx: in place, no atomics.
__global__ void __launch_bounds__(SA_THREADS)
nca_bwd_adjoint_kernel(const float* __restrict__ gp, float* __restrict__ gx,
                       const float* __restrict__ gtap, int C, int H, int W, int vec) {
  extern __shared__ __align__(16) float smem[];  // [ADJ1_CG][3][SA_PLANE]
  const int tid = threadIdx.x;
  const int ng = (C + ADJ1_CG - 1) / ADJ1_CG;
  const int b = blockIdx.z / ng, c0 = (blockIdx.z - b * ng) * ADJ1_CG;
  const int HW = H * W;
  const int y0 = blockIdx.y * SA_TH, x0 = blockIdx.x * SA_TW;
  const float* gpb = gp + (size_t)b * 4 * C * HW;
  int off[SA_SLOTS];
  plane_slots(off, y0, x0, H, W, true, vec, tid);
#pragma unroll
  for (int e = 0; e < ADJ1_CG; ++e) {
    if (c0 + e < C) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        stage_plane(smem + (e * 3 + k) * SA_PLANE, gpb + (size_t)((k + 1) * C + c0 + e) * HW,
                    off, 0.f, vec, tid);
    }
    cp_async_commit();
  }
  // the thread's 4 pixels: tile row r, columns 4j .. 4j + 3
  const int j = tid % (SA_TW / 4), r = tid / (SA_TW / 4);
  const int py = y0 + r, px = x0 + 4 * j;
  const int n = py < H ? max(0, min(4, W - px)) : 0;
  const size_t pix = (size_t)py * W + px;
  float raw[ADJ1_CG][4], g[ADJ1_CG][4], tap[ADJ1_CG][4];
#pragma unroll
  for (int e = 0; e < ADJ1_CG; ++e) {
    const int ne = c0 + e < C ? n : 0;
    const size_t at = ((size_t)b * C + c0 + e) * HW + pix;
    load_px4(raw[e], gpb + (size_t)(c0 + e) * HW + pix, ne, vec);
    load_px4(g[e], gx + at, ne, vec);
    if (gtap != nullptr) load_px4(tap[e], gtap + at, ne, vec);
  }
  // phase: staging (the copy offsets, the copies' issue and the registers' loads)
#pragma unroll
  for (int e = 0; e < ADJ1_CG; ++e) {
    cp_async_wait_upto(ADJ1_CG - 1 - e);
    __syncthreads();  // waiting: channel e's planes are in
    if (c0 + e < C && n > 0) {
      const float* f = smem + e * 3 * SA_PLANE;
      float wx[3][6], wy[3][6], wl[3][6];
      plane_window(wx, f, r, j);
      plane_window(wy, f + SA_PLANE, r, j);
      plane_window(wl, f + 2 * SA_PLANE, r, j);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = __fadd_rn(g[e][q], stencil_adjoint<6>(raw[e][q], &wx[0][q], &wy[0][q],
                                                     &wl[0][q]));
        if (gtap != nullptr) v[q] = __fadd_rn(v[q], tap[e][q]);
      }
      // phase: adjoint
      store_px4(gx + ((size_t)b * C + c0 + e) * HW + pix, v, n, vec);
    }
    // phase: store
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

// nca_bwd_adjoint_ms's geometry. A block's 16 x 16 pixels read gp on one
// full-resolution footprint a plane: 22 rows from 16 by - 3 (U^T over H of
// the 10 half rows hb - 1 .. hb + 8 reads their children and the 0.25 taps'
// rows, 2 hb - 3 .. 2 hb + 18) and 24 columns from 16 bx - 4 (the 22 that
// U^T over W reads, widened to six aligned float4s), wrapped circularly at
// full resolution; it holds the scale-0 halo (rows 2 .. 19, columns 3 .. 20)
// too. ADJ_CP channels go through a pass, so that every phase keeps at least
// half the block busy.
#define ADJ_FR (2 * NCA_HFOOT + 2)  // footprint rows
#define ADJ_FC 24                   // footprint columns
#define ADJ_PLANE (ADJ_FR * ADJ_FC)
#define ADJ_CP 2                    // channels a pass
#define ADJ_HP (NCA_TILE / 2)       // half pixels under a block, a side
// dynamic shared memory of nca_bwd_adjoint_ms, in floats: two footprint
// buffers [2][CP][4][PLANE], gx and gtap prefetches [2][CP][256] each, U_W^T
// [CP][4][FR][WS], U^T gp [CP][4][10][10]; then ints: the footprint rows'
// offsets and columns
#define ADJ_WS (NCA_HFOOT + 1)  // stride of U_W^T's rows (odd: no bank conflicts)
// a thread's 16-byte footprint copies a pass: of [CP][4][FR][6] float4s,
// ADJ_CP * ADJ_PLANE in all
#define ADJ_NV ((ADJ_CP * ADJ_PLANE + NT_THREADS - 1) / NT_THREADS)
#define ADJ_SMEM_FLOATS                                   \
  (2 * ADJ_CP * 4 * ADJ_PLANE + 4 * ADJ_CP * NT_THREADS + \
   ADJ_CP * 4 * ADJ_FR * ADJ_WS + ADJ_CP * 4 * NCA_HFOOT * NCA_HFOOT)
#define ADJ_SMEM_BYTES (sizeof(float) * ADJ_SMEM_FLOATS + sizeof(int) * (ADJ_FR + ADJ_FC))

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
// device memory. Each channel's 4 gp planes are staged once, on the
// footprint above, by cp.async (16-byte copies when W is a multiple of 4 and
// gp is 16-byte aligned, `vec`; 4-byte ones otherwise), with the circular
// wrap resolved once per footprint row and column; the block's gx and gtap
// values come the same way. Two buffers: pass p + 1's copies fly while pass
// p computes, ADJ_CP channels a pass. Every phase then reads shared memory:
// the scale-0 adjoint (a thread two pixels of a column, of one channel, from
// a 4 x 3 window of each stencil plane in registers) and U^T over W (a
// thread a footprint row: six float4 reads, ten outputs; 176 threads), U^T
// over H (a thread five half rows of a half column; 160 threads), then the
// half-resolution stencil adjoint at the parent half pixel of a thread's two
// pixels (each half pixel formed by the two threads that need it, which
// saves a barrier) and the combine. Three barriers a pass.
// The terms and their order are the first design's (upsample2_t,
// stencil_adjoint, __fadd_rn/__fmul_rn), on the same values, so the result
// is that design's bit for bit.
__global__ void __launch_bounds__(NT_THREADS, 4)
nca_bwd_adjoint_ms_kernel(const float* __restrict__ gp, float* __restrict__ gx,
                          const float* __restrict__ gtap, int C, int H, int W,
                          int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nf = NCA_HFOOT * NCA_HFOOT;
  float* fp = smem;                                // [2][CP][4][PLANE]
  float* gxs = fp + 2 * ADJ_CP * 4 * ADJ_PLANE;    // [2][CP][256]
  float* gts = gxs + 2 * ADJ_CP * NT_THREADS;      // [2][CP][256]
  float* wt = gts + 2 * ADJ_CP * NT_THREADS;       // [CP][4][FR][WS]
  float* gph = wt + ADJ_CP * 4 * ADJ_FR * ADJ_WS;  // [CP][4][10][10]
  int* rows = reinterpret_cast<int*>(gph + ADJ_CP * 4 * nf);  // [FR]
  int* cols = rows + ADJ_FR;                                          // [FC]
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W, H2 = H / 2, W2 = W / 2;
  const int hb = blockIdx.y * ADJ_HP, wb = blockIdx.x * ADJ_HP;
  const int y0 = blockIdx.y * NCA_TILE, x0 = blockIdx.x * NCA_TILE;
  const float* gpb = gp + (size_t)b * 4 * C * HW;

  if (tid < ADJ_FR)
    rows[tid] = pad_index(y0 - 3 + tid, H, 0) * W;
  else if (tid < ADJ_FR + ADJ_FC)
    cols[tid - ADJ_FR] = pad_index(x0 - 4 + tid - ADJ_FR, W, 0);
  // the footprint's half rows (columns) q whose wrapped index is the first
  // or the last: the clamped upsample's edges, as bit q of these masks
  int rfirst = 0, rlast = 0, cfirst = 0, clast = 0;
#pragma unroll
  for (int q = 0; q < NCA_HFOOT; ++q) {
    const int i = pad_index(hb - 1 + q, H2, 0), j = pad_index(wb - 1 + q, W2, 0);
    rfirst |= (i == 0) << q;
    rlast |= (i == H2 - 1) << q;
    cfirst |= (j == 0) << q;
    clast |= (j == W2 - 1) << q;
  }
  __syncthreads();  // the footprint's rows and columns

  // The 16-byte copies of the footprint: a thread's copies are the same in
  // every pass, copy j being float4 i = tid + 256 j of the pass's [CP][4][FR]
  // [6] (its shared-memory offset 4 i), so their offsets in a plane pair
  // (plane k, channel c0 + ch of gp, less c0's planes) are computed once.
  int soff[ADJ_NV];
#pragma unroll
  for (int j = 0; j < ADJ_NV; ++j) {
    const int i = tid + j * NT_THREADS;
    const int m = i % (ADJ_FC / 4), r = (i / (ADJ_FC / 4)) % ADJ_FR;
    const int kk = i / (ADJ_FR * (ADJ_FC / 4));
    soff[j] = i < ADJ_CP * ADJ_PLANE ? ((kk & 3) * C + (kk >> 2)) * HW + rows[r] + cols[4 * m]
                                     : 0;
  }
  // the thread's pixel for gx and gtap (entry (ty & 1) * 128 + (ty >> 1) * 16
  // + tx of a channel's 256: row pairs apart)
  const int sy = tid / NCA_TILE, sx = tid % NCA_TILE;
  const bool svalid = y0 + sy < H && x0 + sx < W;
  const int spix = svalid ? (y0 + sy) * W + x0 + sx : 0;
  const int sslot = (sy & 1) * 128 + (sy >> 1) * NCA_TILE + sx;

  // Pass `pass`'s copies into buffer `buf`: ADJ_CP channels' 4 gp planes on
  // the footprint, then gx and gtap at the block's pixels.
  auto stage = [&](int pass, int buf) {
    const int c0 = pass * ADJ_CP;
    float* dst = fp + buf * ADJ_CP * 4 * ADJ_PLANE;
    const float* src = gpb + (size_t)c0 * HW;
    if (vec) {
#pragma unroll
      for (int j = 0; j < ADJ_NV; ++j) {
        const int i = tid + j * NT_THREADS;
        if (i < ADJ_CP * ADJ_PLANE && c0 + i / ADJ_PLANE < C)
          cp_async16(dst + 4 * i, src + soff[j]);
      }
    } else {
      for (int i = tid; i < ADJ_CP * 4 * ADJ_PLANE; i += NT_THREADS) {
        const int q = i % ADJ_FC, r = (i / ADJ_FC) % ADJ_FR, kk = i / ADJ_PLANE;
        if (c0 + (kk >> 2) < C)
          cp_async4(dst + i, src + ((kk & 3) * C + (kk >> 2)) * HW + rows[r] + cols[q]);
      }
    }
#pragma unroll
    for (int e = 0; e < ADJ_CP; ++e) {
      if (svalid && c0 + e < C) {
        const size_t at = ((size_t)b * C + c0 + e) * HW + spix;
        const int o = (buf * ADJ_CP + e) * NT_THREADS + sslot;
        cp_async4(gxs + o, gx + at);
        if (gtap != nullptr) cp_async4(gts + o, gtap + at);
      }
    }
    cp_async_commit();
  };

  // the scale-0 adjoint and the combine: channel dch of the pass, column dx,
  // pixel rows 2 dy2 and 2 dy2 + 1 (one parent half row)
  const int dch = tid / (NT_THREADS / ADJ_CP), dx = tid % NCA_TILE;
  const int dy2 = (tid / NCA_TILE) % ADJ_HP;
  // U^T over W: footprint row ar of plane ak (ch * 4 + k) of the pass
  const int ak = tid / ADJ_FR, ar = tid % ADJ_FR;
  // U^T over H: half column bq, half rows 5 bh .. 5 bh + 4, plane bk
  const int bq = tid % NCA_HFOOT, bh = (tid / NCA_HFOOT) & 1, bk = tid / (2 * NCA_HFOOT);
  const int npass = (C + ADJ_CP - 1) / ADJ_CP;
  stage(0, 0);
  for (int pass = 0; pass < npass; ++pass) {
    const int buf = pass & 1, c0 = pass * ADJ_CP;
    cp_async_wait_group<0>();
    __syncthreads();  // staging: this pass's footprint is in, the last pass's arrays are read
    if (pass + 1 < npass) stage(pass + 1, buf ^ 1);
    // phase: issue the next pass's copies
    const float* f = fp + buf * ADJ_CP * 4 * ADJ_PLANE;
    // the scale-0 adjoint of the thread's two pixels: the 4 x 3 window of
    // each stencil plane from footprint (2 dy2 + 2, dx + 3), the raw values
    // at (2 dy2 + 3 + e, dx + 4)
    float adj0[2] = {0.f, 0.f};
    const bool dvalid = c0 + dch < C;
    if (dvalid) {
      const float* fk = f + dch * 4 * ADJ_PLANE + (2 * dy2 + 2) * ADJ_FC + dx + 3;
      float win[3][4][3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) win[k][r][q] = fk[(k + 1) * ADJ_PLANE + r * ADJ_FC + q];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        adj0[e] = stencil_adjoint<3>(fk[(e + 1) * ADJ_FC + 1], &win[0][e][0], &win[1][e][0],
                                     &win[2][e][0]);
    }
    // U^T over W: half column q (half index wb - 1 + q) reads footprint
    // columns 2q + 1 .. 2q + 4 of the row
    if (tid < ADJ_CP * 4 * ADJ_FR && c0 + (ak >> 2) < C) {
      const float4* t4 = reinterpret_cast<const float4*>(f + ak * ADJ_PLANE + ar * ADJ_FC);
      float t[ADJ_FC];
#pragma unroll
      for (int m = 0; m < ADJ_FC / 4; ++m) {
        const float4 v = t4[m];
        t[4 * m] = v.x;
        t[4 * m + 1] = v.y;
        t[4 * m + 2] = v.z;
        t[4 * m + 3] = v.w;
      }
      float* o = wt + tid * ADJ_WS;
#pragma unroll
      for (int q = 0; q < NCA_HFOOT; ++q)
        o[q] = upsample2_t(t[2 * q + 2], t[2 * q + 3],
                           (cfirst >> q) & 1 ? t[2 * q + 2] : t[2 * q + 1],
                           (clast >> q) & 1 ? t[2 * q + 3] : t[2 * q + 4]);
    }
    __syncthreads();  // the scale-0 adjoint (registers) and U^T over W
    // U^T over H: half row r = 5 bh + i reads U_W^T rows 2r .. 2r + 3
    if (tid < ADJ_CP * 4 * 2 * NCA_HFOOT && c0 + (bk >> 2) < C) {
      const float* col = wt + (bk * ADJ_FR + 10 * bh) * ADJ_WS + bq;
      float v[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) v[j] = col[j * ADJ_WS];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int r = 5 * bh + i;
        gph[bk * nf + r * NCA_HFOOT + bq] =
            upsample2_t(v[2 * i + 1], v[2 * i + 2], (rfirst >> r) & 1 ? v[2 * i + 1] : v[2 * i],
                        (rlast >> r) & 1 ? v[2 * i + 2] : v[2 * i + 3]);
      }
    }
    __syncthreads();  // U^T over H
    if (dvalid) {
      // the half-resolution stencil adjoint at the pixels' parent half pixel
      // (the two threads of a parent pair each form it)
      const float* sh = gph + dch * 4 * nf;
      const int w0 = dy2 * NCA_HFOOT + (dx >> 1);  // the 3x3 window's top-left
      const float h = stencil_adjoint<NCA_HFOOT>(sh[w0 + NCA_HFOOT + 1], sh + nf + w0,
                                                 sh + 2 * nf + w0, sh + 3 * nf + w0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int py = y0 + 2 * dy2 + e, px = x0 + dx;
        if (py < H && px < W) {
          const int s = (buf * ADJ_CP + dch) * NT_THREADS + e * 128 + dy2 * NCA_TILE + dx;
          float v = __fadd_rn(gxs[s], __fmul_rn(__fadd_rn(adj0[e], __fmul_rn(h, 0.25f)), 0.5f));
          if (gtap != nullptr) v = __fadd_rn(v, gts[s]);
          gx[((size_t)b * C + c0 + dch) * HW + (size_t)py * W + px] = v;
        }
      }
    }
    // phase: the half-resolution stencil adjoint, the combine and the store
  }
}

static dim3 adjoint_grid(int B, int C, int H, int W) {
  return dim3((W + SA_TW - 1) / SA_TW, (H + SA_TH - 1) / SA_TH,
              B * ((C + ADJ1_CG - 1) / ADJ1_CG));
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
      F4 > NCA_F_MAX || F4 % 4 != 0 || (ms && (H % 2 || W % 2)) ||
      reinterpret_cast<uintptr_t>(w1) % 16 != 0)  // W1 rows go by cp.async
    return (int)cudaErrorInvalidValue;
  const int P = 4 * C + cc;
  const int PN = (P + 8) & ~7, FP = (F4 + NB_FC - 1) / NB_FC * NB_FC;
  // hs/gzs (2 * NB_FC columns) hold the state tile, and with ms the half
  // tile and percept, until the percept columns are built:
  // C * (18^2 + 12^2 + 4 * 10^2) <= 13888 floats fit in them
  const size_t smem =
      sizeof(float) * ((size_t)PN * (FP + 8) + (size_t)FP * NB_LDW2 + 2 * FP +
                       (size_t)(PN + NCA_C_MAX + 2 * NB_FC) * NB_LDM + NB_RED +
                       2 * NT_THREADS);
  const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE,
                  B);
  const dim3 block(NB_THREADS);
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
  // (the MS kernel's offsets within a batch item's gp are 32-bit)
  if (C < 1 || C > NCA_C_MAX || (ms && (H % 2 || W % 2 || 4LL * C * H * W >= (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ms) {
    const dim3 grid((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE, B);
    const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(gp) % 16 == 0;
    cudaFuncSetAttribute(nca_bwd_adjoint_ms_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ADJ_SMEM_BYTES);
    nca_bwd_adjoint_ms_kernel<<<grid, dim3(NT_THREADS), ADJ_SMEM_BYTES, s>>>(gp, gx, gtap, C,
                                                                            H, W, vec);
  } else {
    const dim3 grid = adjoint_grid(B, C, H, W);
    if (grid.z > 65535) return (int)cudaErrorInvalidValue;
    const auto a16 = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const int vec = W % 4 == 0 && a16(gp) && a16(gx) && (gtap == nullptr || a16(gtap));
    nca_bwd_adjoint_kernel<<<grid, SA_THREADS, ADJ1_SMEM_BYTES, s>>>(gp, gx, gtap, C, H, W,
                                                                     vec);
  }
  return (int)cudaGetLastError();
}

// nca_bwd_adjoint's launch at [B, C, H, W]: its blocks in *n_blocks, blocks
// an SM (cudaOccupancy...) in *blocks, its dynamic shared memory in
// *smem_bytes.
int nca_bwd_adjoint_geometry(int B, int C, int H, int W, int* n_blocks, int* blocks,
                             int* smem_bytes) {
  const dim3 grid = adjoint_grid(B, C, H, W);
  *n_blocks = (int)(grid.x * grid.y * grid.z);
  *smem_bytes = (int)ADJ1_SMEM_BYTES;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, nca_bwd_adjoint_kernel, SA_THREADS,
                                                ADJ1_SMEM_BYTES);
  return (int)cudaGetLastError();
}

// Blocks an SM of nca_bwd_adjoint_ms (cudaOccupancy...), with its dynamic
// shared memory in *smem_bytes.
int nca_bwd_adjoint_ms_occupancy(int* blocks, int* smem_bytes) {
  *smem_bytes = (int)ADJ_SMEM_BYTES;
  cudaFuncSetAttribute(nca_bwd_adjoint_ms_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ADJ_SMEM_BYTES);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, nca_bwd_adjoint_ms_kernel,
                                                NT_THREADS, ADJ_SMEM_BYTES);
  return (int)cudaGetLastError();
}

}  // extern "C"
