// One DyNCA step on NCHW state — the Hopper kernels of the rollout.
//
// Replaces (vsnca_tpu/ops/pallas_step.py):
//   * _make_kernel_flat        (:1411, called by fused_rollout_flat_chw :1541)
//   * _make_kernel_stream_flat (:1621, called by fused_rollout_stream_flat_chw
//     :1819), the same function for circular grids past the TPU's VMEM cap.
//   * _make_kernel_roll        (:175, fused_rollout_chw :590 with algo "roll"
//     and a float32 state) and _make_kernel_stream (:845,
//     fused_rollout_stream_chw :1008), the CHW layouts of the same step;
//   * the CHW training pair's forward and in-kernel recompute
//     (pallas_train.py _make_fwd_kernel :390, _make_bwd_kernel :485), which
//     ops/fused_train.py runs as launches of the chain form under its
//     segment walk.
// All compute, per step: perception [x | sobel_x | sobel_y | laplacian]
// under circular / replicate / zeros padding, append the conditioning
// channels, h = relu(W1^T p + b1), dx = W2^T h + b2, and x += dx * mask with
// mask = (u24 >= thr). The TPU kernels keep the state resident in VMEM for
// the whole rollout; these kernels keep nothing on chip between steps, so
// they have no resident-state cap and one kernel covers them all.
//
// What bounds it on an H100: per pixel and step the MLP is 2*(P*F + F*C)
// FLOP (c12/fc96/cc3: 12.1 kFLOP; c16/fc128/cc2: 21.0 kFLOP) against
// (2C + cc) * 4 = 108 bytes of state and conditioning (c12/cc3), about 112
// FLOP/byte. Device memory (3.35 TB/s) bounds the step at ~2.1 us for 256^2;
// the MLP in split TF32 (three TF32 products, 495 TFLOP/s) takes ~1.5 us, in
// bf16 (989 TFLOP/s) ~0.16 us, as float32 FMAs on the CUDA cores (67
// TFLOP/s) ~12 us.
//
// Two forms of the step, one template and one launch each:
//
// nca_step_kernel — the rollout (every rollout entry, the stylizers and
// the server) but where the chain form runs: the MLP on the tensor cores. A 16 x 16 block of 256 threads (8
// warps, two blocks an SM) stages the C x 18 x 18 halo tile (resolved by
// the padding mode) and the weights (cp.async), each thread forms its
// pixel's percept in registers through the shared device functions
// (nca_common.cuh: stencils, half_percept, ms_average) and, once the tile
// is consumed, lands it as a column of the percept [P, 256] in the tile's
// shared memory. Each warp then owns 32 pixels (two m16 tiles) and walks
// the hidden units in chunks of 32: z1 = P^T W1 through nca_mma.cuh's
// z1_mma and z1_finish (split TF32 under float32 compute, exact bf16
// products under bf16 compute; the bias; the near-zero certificate), h =
// relu(z1), rounded to bf16 as the A operand under bf16 compute (JAX
// rounds the hidden activations, pallas_step.py:1379), fed from registers
// (the paired map) into dx += h W2 on the tensor cores, which accumulates
// over the chunks. The output fragment (pixels g and g + 8 of a tile,
// channels 2t and 2t + 1) takes the bias, the hash mask and the float32
// residual add from the state, read again from device memory (L2) because
// the tile's memory now holds the percept, and the store rounding of the
// bf16-state form; a store writes 8 consecutive pixels of 4 channels.
// Shared memory at c16/fc128/cc2 (MS): W1 34.8 KB + W2 10.2 KB + biases,
// norms and pixel maxima 2.1 KB + max(percept 67.6 KB, tiles 55.6 KB) =
// 114.8 KB, two blocks an SM (ptxas caps registers at 128); at
// c12/fc96/cc3 82.2 KB, two blocks an SM. No atomics, a fixed order of
// every add: two launches give the same bits. Against the plain version
// (float32 products in the chain order) a state differs by rounding: the
// split TF32 sum is within ~2^-21 of each product.
//
// The chain form — nca_step_kernel<BF16, MS, float, true> — the training
// pair's forward and its segment recompute, and the scales-(0,) rollout
// under bf16 compute with a float32 state (the served step: its percept is
// rounded to bf16 every step, so a one-ulp difference of state flips
// percept roundings, and the tensor-core form drifted 2.07e-3 from the
// plain version over 24 steps at 256^2 against a 1e-3 tolerance;
// fused_step.py::chain_form): the same
// staging and percept columns, then the MLP as float32 FMAs on the CUDA
// cores in the plain version's order (z1 over the percept rows in order,
// then the bias; dx over the units in order), so the pair's states, and
// with them its relu gates, are the plain version's bits. A forward in
// tensor-core arithmetic reaches slightly different states; where a relu
// input on that trajectory lies within its rounding of zero the gate flips,
// and a flipped gate moves the pair's gradient by ~1e-4 to 1e-3 of its
// largest element (tests/test_torch_tc_split.py emulates it), past the
// pair's tolerance against the plain pair. The backward (nca_train.cu)
// recomputes z1 through z1_mma/z1_finish, whose certificate gives it the
// chain's gates bit for bit. A thread forms z1 for 4 units x 8 pixels from
// a broadcast float4 of W1 and 8 percept reads a row (32 FMAs), relu(z1)
// goes to a [32, 256] chunk in shared memory, and a thread accumulates dx
// for 4 adjacent pixels x 4 channels (a float4 of h and one of W2 a unit,
// 16 FMAs). Its FMAs and those reads pace it. The chunk adds 32.8 KB; W1
// stays in shared memory where two blocks an SM still fit (113.5 KB at
// c12/fc96/cc2), else a warp reads one float4 of it a row, the same address
// in every lane, through L1 (112.7 KB at c16/fc128/cc2 MS): a second block
// an SM pays for the L1 reads there, not where two fit anyway.
//
// bf16 mode rounds (round to nearest even) exactly where the TPU kernel
// casts to its compute dtype: the percept (pallas_step.py:1176), the hidden
// activations (:1379) and W1^T / W2^T (:1529-1531; rounded by the wrapper's
// weight packing). Biases, state and accumulation stay float32.
//
// The mask is a counter-based hash of (seed, batch, step, pixel), written
// once in nca_common.cuh and once in torch integer ops
// (fused_step.py::mask_bits), so the kernels and their plain version draw
// bit-identical masks, and the training backward (nca_train.cu) replays
// them.
//
// The MS = true forms (nca_step_ms) — perception_scales (0, 1) — replace
//   * _make_kernel_roll_ms          (pallas_step.py:308, called by
//     fused_rollout_chw :731), the multiscale inference rollout (the
//     tensor-core form),
//   * _make_fwd_kernel_flat_tiled_ms (pallas_train.py:1031, called by
//     _fwd_call_flat_tiled_ms :2144), the multiscale training forward (the
//     chain form; ops/fused_train.py launches it once a step into the
//     checkpoint).
// Per step they compute perceive_multiscale: the state's exact 2x2 mean at
// half resolution, that half state's stencils under the padding mode, the
// 0.75/0.25 upsample with edge clamping, the average with the scale-0
// percept. The half state is a prologue, not a separate launch: each block
// builds the 12 x 12 half-state tile it needs straight from the state (each
// half pixel reads its four full pixels, ~1.8x the full tile's reads, from
// L2), then the 4C x 10 x 10 half percept of its footprint in shared memory
// (nca_common.cuh::half_percept), and each thread upsamples its pixel's
// share of it (ms_average). Nothing of the half resolution reaches device
// memory, so the training backward recomputes it from the checkpointed
// state through the same device functions rather than keep a second buffer
// a step. The half percept adds ~0.3 kFLOP a pixel to ~12-37 kFLOP.

// The bf16-state form — nca_step_kernel<BF16, false, __nv_bfloat16> —
// replaces _make_kernel (pallas_step.py:498, fused_rollout_chw with algo
// "padded" and state_dtype "bfloat16"): the state and the conditioning are
// stored as bf16 (half the bytes of a float32 step), read into float32
// registers, the stencils round every product and partial sum to bf16 as JAX
// computes them on a bf16 array, the residual add is float32, and the new
// state is rounded to bf16 on store.
//
// nca_step_mat replaces _make_kernel_roll(mat_stencil=True) (pallas_step.py
// :175, algo "mat"): the stencils are folded into the first layer
// (stencil_folded_w1 :148), z1 = W_eff^T [the 3x3 taps of every channel, 9C
// values | cond] + b1, then the same ReLU, second layer, mask and residual.
// Per pixel that is 2*((9C + cc)*F + F*C) FLOP (c12/fc96/cc3: 23.6 kFLOP,
// about twice nca_step's), as float32 FMAs on the CUDA cores; the TPU
// kernel moved the stencil arithmetic onto its matrix unit, and a
// tensor-core (implicit-GEMM) form of this kernel is where that pays here.
// It reuses nca_step's C x 18 x 18 halo tile and padding rule and reads the
// taps from that shared tile (not registers: 9C taps would not fit beside
// the accumulators). W_eff is up to 148 x 128 floats, 75.8 KB, past the
// 48 KB default of shared memory: the launch raises the block's dynamic
// shared-memory limit with cudaFuncSetAttribute. Under bf16 compute it
// rounds where JAX does: W_eff after the float32 fold (by the wrapper), the
// raw taps (not a percept) and the hidden activations.

#include "nca_common.cuh"
#include "nca_mma.cuh"

#define NS_THREADS (NCA_TILE * NCA_TILE)  // pixels of a block, one thread each
#define NS_FC 32                          // hidden units a chunk (tensor-core form)
#define NS_LDW2 20                        // stride of W2's rows in shared memory
// Dynamic shared memory of a block when two blocks share an SM: (the SM's
// 228 KB less 1 KB reserved a block) / 2.
#define NS_SMEM_TWO ((233472 / 2) - 1024)

// nca_step_kernel's shared memory in floats (see its layout): the chain
// form adds hs, and keeps W1 out of it when two blocks would not fit with
// it (chain_w1_staged).
__host__ __device__ inline size_t step_floats(int C, int cc, int F4, bool ms, bool chain,
                                              bool w1) {
  const size_t P = 4 * C + cc, FP = (F4 + NS_FC - 1) / NS_FC * NS_FC;
  size_t tiles = (size_t)C * NCA_HALO * NCA_HALO;
  if (ms) tiles += (size_t)C * (NCA_HHALO * NCA_HHALO + 4 * NCA_HFOOT * NCA_HFOOT);
  const size_t cols = P * NS_THREADS;  // > tiles: 4C x 256 against <= 868 C
  return (w1 ? P * (FP + 4) : 0) + FP * NS_LDW2 + 2 * FP + NCA_C_MAX + NS_THREADS +
         (cols > tiles ? cols : tiles) + (chain ? NS_FC * NS_THREADS : 0);
}

// Whether the chain form stages W1 in shared memory (two blocks an SM
// still fit) or reads it through L1.
__host__ __device__ inline bool chain_w1_staged(int C, int cc, int F4, bool ms) {
  return step_floats(C, cc, F4, ms, true, true) * sizeof(float) <= NS_SMEM_TWO;
}

// One pixel's percept in registers: pc[k][c] is block k (raw, sx, sy, lap)
// of channel c, pcond[j] conditioning channel j (condb: the batch's
// conditioning, null when cc == 0), zeros past C and cc; rounded to bf16
// under bf16 compute. The stencils read the block's state tile (with BSTATE
// in bf16 arithmetic, as JAX computes a bf16 state's); MS averages them with
// the block's half percept hp. Every index of pc is a compile-time constant
// after unrolling.
template <bool BF16, bool MS, bool BSTATE, typename T>
__device__ __forceinline__ void pixel_percept(float pc[4][NCA_C_MAX],
                                              float pcond[NCA_CC_MAX],
                                              const float* tile, const float* hp,
                                              const T* condb, int C, int cc, int H,
                                              int W, int ty, int tx, int pix) {
  int fi = 0, fin = 0, fj = 0, fjn = 0;
  if (MS) {
    upsample_taps(blockIdx.y, ty, H, fi, fin);
    upsample_taps(blockIdx.x, tx, W, fj, fjn);
  }
  const int nf = NCA_HFOOT * NCA_HFOOT;
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) {
    if (c < C) {
      const float* t = tile + (c * NCA_HALO + ty) * NCA_HALO + tx;
      float sx, sy, lap;
      stencils<NCA_HALO, BSTATE>(t, sx, sy, lap);
      pc[0][c] = t[NCA_HALO + 1];
      pc[1][c] = sx;
      pc[2][c] = sy;
      pc[3][c] = lap;
      if (MS) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pc[k][c] = ms_average(hp + (k * C + c) * nf, fi, fin, fj, fjn, pc[k][c]);
      }
    } else {
      pc[0][c] = pc[1][c] = pc[2][c] = pc[3][c] = 0.f;
    }
  }
  const size_t HW = (size_t)H * W;
#pragma unroll
  for (int j = 0; j < NCA_CC_MAX; ++j)
    pcond[j] = j < cc ? to_float(condb[j * HW + pix]) : 0.f;
  if (BF16) {
#pragma unroll
    for (int c = 0; c < NCA_C_MAX; ++c) {
#pragma unroll
      for (int k = 0; k < 4; ++k) pc[k][c] = bf16_round(pc[k][c]);
    }
#pragma unroll
    for (int j = 0; j < NCA_CC_MAX; ++j) pcond[j] = bf16_round(pcond[j]);
  }
}

// The tensor-core form and, with CHAIN, the chain form (see the header).
// Shared memory, float32, in this order (every part a multiple of 4 floats):
//   w1s [P, LDW]   W1, rows in the percept's block order, zero past F4
//   w2s [FP, 20]   W2 (unit-major), zero past F4 and C
//   b1s, w1n [FP]  b1 (zero past F4); sum_k |W1[k][u]| for the certificate
//   b2s [C_MAX]
//   pmx [256]      max_k |p_k| of each pixel, for the certificate
//   ps  [P, 256]   percept columns (swizzled, nca_mma.cuh::Cols), which
//                  first hold tile [C, 18, 18] and with MS htile [C, 12, 12]
//                  and hp [4C, 10, 10]
//   CHAIN only: hs [32, 256]  relu(z1) of a chunk of 32 units; and no w1s
//                  where two blocks an SM would not fit with it
//                  (chain_w1_staged: the chain form then reads W1 through L1)
// FP = F4 rounded up to 32 (zero units: relu(0) W2 = 0), LDW = FP + 4.
// T is the state's (and the conditioning's) storage type: float, or
// __nv_bfloat16 for the bf16-state form (MS only with float; CHAIN only
// with float).
template <bool BF16, bool MS, typename T = float, bool CHAIN = false>
__global__ void __launch_bounds__(NS_THREADS, 2)
nca_step_kernel(const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ cond, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int C, int H, int W, int cc,
                int F4, int pad_mode, uint32_t seed, uint32_t step,
                uint32_t thr) {
  constexpr bool BSTATE = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int P = 4 * C + cc;
  const int FP = (F4 + NS_FC - 1) / NS_FC * NS_FC, LDW = FP + 4;
  const bool staged = !CHAIN || chain_w1_staged(C, cc, F4, MS);
  float* w1s = smem;
  float* w2s = w1s + (staged ? P * LDW : 0);
  float* b1s = w2s + FP * NS_LDW2;
  float* w1n = b1s + FP;
  float* b2s = w1n + FP;
  float* pmx = b2s + NCA_C_MAX;
  float* ps = pmx + NS_THREADS;
  float* tile = ps;
  float* htile = tile + C * NCA_HALO * NCA_HALO;
  float* hp = htile + C * NCA_HHALO * NCA_HHALO;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & (NCA_TILE - 1);
  const int b = blockIdx.z;
  const int HW = H * W;

  // The weights by cp.async (W1's rows 16 bytes at a time: F4 and LDW are
  // multiples of 4), the padding by plain stores; waited for with the tile.
  if (staged) {
    const int q4 = F4 / 4;
    for (int i = tid; i < P * q4; i += NS_THREADS) {
      const int r = i / q4, q = i - r * q4;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(w1s + r * LDW + 4 * q);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(w1 + (size_t)r * F4 + 4 * q));
    }
    for (int i = tid; i < P * (LDW - F4); i += NS_THREADS) {
      const int r = i / (LDW - F4);
      w1s[r * LDW + F4 + (i - r * (LDW - F4))] = 0.f;
    }
  }
  for (int i = tid; i < FP * NS_LDW2; i += NS_THREADS) {
    const int f = i / NS_LDW2, c = i - f * NS_LDW2;
    if (f < F4 && c < C)
      cp_async4(w2s + i, w2 + f * C + c);
    else
      w2s[i] = 0.f;
  }
  for (int i = tid; i < FP; i += NS_THREADS) {
    if (i < F4)
      cp_async4(b1s + i, b1 + i);
    else
      b1s[i] = 0.f;
  }
  if (tid < NCA_C_MAX) b2s[tid] = tid < C ? b2[tid] : 0.f;

  const T* xb = x + (size_t)b * C * HW;
  if constexpr (BSTATE) {
    stage_tile(tile, xb, C, H, W, blockIdx.y * NCA_TILE - 1, blockIdx.x * NCA_TILE - 1,
               pad_mode, tid, NS_THREADS);
  } else {
    stage_tile_async(tile, xb, C, H, W, blockIdx.y * NCA_TILE - 1,
                     blockIdx.x * NCA_TILE - 1, pad_mode, tid, NS_THREADS);
    if constexpr (MS)  // its loads overlap the tile's copies
      half_percept(htile, hp, xb, C, H, W, blockIdx.y, blockIdx.x, pad_mode, tid,
                   NS_THREADS);
  }
  cp_async_wait_all();
  __syncthreads();  // the weights, the state tile and the half percept

  if constexpr (!CHAIN) z1_norms(w1n, w1s, LDW, P, FP, tid, NS_THREADS);
  const int px = blockIdx.x * NCA_TILE + tx;
  const int py = blockIdx.y * NCA_TILE + ty;
  const bool valid = px < W && py < H;
  float pc[4][NCA_C_MAX];
  float pcond[NCA_CC_MAX];
  if (valid) {
    pixel_percept<BF16, MS, BSTATE>(pc, pcond, tile, hp,
                                    cc ? cond + (size_t)b * cc * HW : cond, C, cc, H, W,
                                    ty, tx, py * W + px);
  } else {  // zeros: the pixel is computed and never stored
#pragma unroll
    for (int c = 0; c < NCA_C_MAX; ++c) pc[0][c] = pc[1][c] = pc[2][c] = pc[3][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NCA_CC_MAX; ++j) pcond[j] = 0.f;
  }
  __syncthreads();  // every read of the tiles is done: the percept takes their memory

  const Cols cols{ps, NS_THREADS, -1};
  float pm = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < NCA_C_MAX; ++c) {
      if (c < C) {
        ps[cols.idx(k * C + c, tid)] = pc[k][c];
        pm = fmaxf(pm, fabsf(pc[k][c]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NCA_CC_MAX; ++j) {
    if (j < cc) {
      ps[cols.idx(4 * C + j, tid)] = pcond[j];
      pm = fmaxf(pm, fabsf(pcond[j]));
    }
  }
  pmx[tid] = pm;
  __syncthreads();  // the percept columns, pmx and w1n

  if constexpr (CHAIN) {
    // z1 as the plain version's FMA chain (rows in order, then the bias):
    // a thread takes 4 units of the chunk (its warp's) for 8 pixels 32
    // apart, a float4 of W1 (the same address across the warp, from L1) and
    // 8 percept reads feeding 32 FMAs a row; relu(z1) (rounded to bf16 under
    // bf16 compute) to hs. Then dx += W2^T h in unit order, a thread 4
    // adjacent pixels x 4 channels.
    float* hs = ps + P * NS_THREADS;
    const int warp = tid >> 5, lane = tid & 31;
    const int q = tid & 63, cg = tid >> 6;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 1
    for (int f0 = 0; f0 < FP; f0 += NS_FC) {
      const int u0 = f0 + 4 * warp;
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
      // W1's rows from shared memory, or through L1 (the row stride in
      // float4s; a padded unit's z1 is never read)
      const float4* w1u = reinterpret_cast<const float4*>(staged ? w1s + u0 : w1 + u0);
      const int ld4 = (staged ? LDW : F4) / 4;
      const bool unit = staged || u0 < F4;
#pragma unroll 2
      for (int k = 0; k < P; ++k) {
        const float4 w = unit ? w1u[k * ld4] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float* pk = ps + cols.idx(k, lane);  // pixel lane + 32 i at pk[32 i]
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = pk[32 * i];
          a[i][0] = fmaf(w.x, v, a[i][0]);
          a[i][1] = fmaf(w.y, v, a[i][1]);
          a[i][2] = fmaf(w.z, v, a[i][2]);
          a[i][3] = fmaf(w.w, v, a[i][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bb = b1s[u0 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float h = fmaxf(a[i][j] + bb, 0.f);
          hs[(4 * warp + j) * NS_THREADS + lane + 32 * i] = BF16 ? bf16_round(h) : h;
        }
      }
      __syncthreads();  // relu(z1) of the chunk
      const int nf = min(NS_FC, F4 - f0);  // the plain version's units, in order
      for (int f = 0; f < nf; ++f) {
        const float4 h = *reinterpret_cast<const float4*>(hs + f * NS_THREADS + 4 * q);
        const float4 w = *reinterpret_cast<const float4*>(w2s + (f0 + f) * NS_LDW2 + 4 * cg);
        const float hv[4] = {h.x, h.y, h.z, h.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wv[c], hv[i], acc[i][c]);
        }
      }
      __syncthreads();  // the next chunk rewrites hs
    }
    const int qy = blockIdx.y * NCA_TILE + (4 * q >> 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qx = blockIdx.x * NCA_TILE + ((4 * q + i) & (NCA_TILE - 1));
      if (qx < W && qy < H) {
        const int pix = qy * W + qx;
        const bool on = (mask_bits(seed, (uint32_t)b, step, (uint32_t)pix) >> 8) >= thr;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ch = 4 * cg + c;
          if (ch < C) {
            // the residual add is float32, from the state (the plain
            // version's order: x + (dx + b2))
            const float xc = to_float(xb[(size_t)ch * HW + pix]);
            out[((size_t)b * C + ch) * HW + pix] =
                from_float<T>(on ? xc + (acc[i][c] + b2s[ch]) : xc);
          }
        }
      }
    }
  } else {
    // This warp's 32 pixels (tile rows 2 warp, 2 warp + 1) as two m16 tiles:
    // z1 for a chunk of 32 units, then dx += relu(z1) W2 over the chunk's two
    // depth blocks of 16 units (paired map), dx in C fragments over the chunks.
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int m0 = 32 * warp;
    const int nct = (C + 7) / 8;
    float dx[2][2][4];
  #pragma unroll
    for (int i = 0; i < 2; ++i) {
  #pragma unroll
      for (int j = 0; j < 2; ++j) dx[i][j][0] = dx[i][j][1] = dx[i][j][2] = dx[i][j][3] = 0.f;
    }
  #pragma unroll 1
    for (int f0 = 0; f0 < FP; f0 += NS_FC) {
      float z[2][NS_FC / 8][4];
      z1_mma<BF16, 2, NS_FC / 8>(z, cols, w1s, LDW, P, m0, f0, g, t);
      z1_finish<2, NS_FC / 8>(z, cols, w1s, LDW, b1s, w1n, pmx, pmx, P, m0, f0, g, t);
      // phase: z1 (z1_mma, z1_finish)
  #pragma unroll
      for (int jj = 0; jj < NS_FC / 16; ++jj) {
        FragA<BF16> fa[2];
  #pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ha[4], hb[4];
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            ha[e] = fmaxf(z[i][2 * jj][e], 0.f);
            hb[e] = fmaxf(z[i][2 * jj + 1][e], 0.f);
          }
          fa[i].paired(ha, hb);
        }
        const float* wr = w2s + (f0 + 16 * jj + 2 * t) * NS_LDW2 + g;
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j < nct) {
            const float bv[4] = {wr[8 * j], wr[NS_LDW2 + 8 * j], wr[8 * NS_LDW2 + 8 * j],
                                 wr[9 * NS_LDW2 + 8 * j]};
            FragB<BF16> fb;
            fb.set(bv);
  #pragma unroll
            for (int i = 0; i < 2; ++i) mma_frag<BF16>(dx[i][j], fa[i], fb);
          }
        }
      }
      // phase: the second layer, dx += relu(z1) W2
    }

    // Pixel g (+ 8) of each tile, channels 8 j + 2 t (+ 1): bias, mask and the
    // float32 residual add from the state (a bf16 state rounded on store).
    T* ob = out + (size_t)b * C * HW;
  #pragma unroll
    for (int i = 0; i < 2; ++i) {
  #pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + 16 * i + g + 8 * hh;
        const int qx = blockIdx.x * NCA_TILE + (m & (NCA_TILE - 1));
        const int qy = blockIdx.y * NCA_TILE + (m >> 4);
        if (qx < W && qy < H) {
          const int pix = qy * W + qx;
          const bool on = (mask_bits(seed, (uint32_t)b, step, (uint32_t)pix) >> 8) >= thr;
  #pragma unroll
          for (int j = 0; j < 2; ++j) {
  #pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * t + e;
              if (j < nct && c < C) {
                const float xc = to_float(xb[(size_t)c * HW + pix]);
                ob[(size_t)c * HW + pix] =
                    from_float<T>(on ? xc + (dx[i][j][2 * hh + e] + b2s[c]) : xc);
              }
            }
          }
        }
      }
    }
    // phase: bias, mask, residual and store
  }
}

// nca_step_mat: the folded-stencil step (see the header). Shared memory, all
// float32, in this order: w1s [9C + cc, F4] (W_eff, rows (di*3 + dj)*C + c,
// then the conditioning rows), w2s [F4, C_MAX], b1s [F4], b2s [C_MAX],
// tile [C, 18, 18]. In bf16 mode the tile is rounded to bf16 in place after
// each thread has kept its own pixel's float32 state for the residual.
template <bool BF16>
__global__ void __launch_bounds__(NCA_TILE * NCA_TILE)
nca_step_mat_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const float* __restrict__ cond,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, int C, int H, int W, int cc,
                    int F4, int pad_mode, uint32_t seed, uint32_t step,
                    uint32_t thr) {
  extern __shared__ __align__(16) float smem[];
  const int P = 9 * C + cc;
  float* w1s = smem;
  float* w2s = w1s + P * F4;
  float* b1s = w2s + F4 * NCA_C_MAX;
  float* b2s = b1s + F4;
  float* tile = b2s + NCA_C_MAX;

  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int nthr = NCA_TILE * NCA_TILE;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int nt = C * NCA_HALO * NCA_HALO;

  for (int i = tid; i < P * F4; i += nthr) w1s[i] = w1[i];
  for (int i = tid; i < F4 * NCA_C_MAX; i += nthr) {
    const int f = i / NCA_C_MAX, c = i % NCA_C_MAX;
    w2s[i] = c < C ? w2[f * C + c] : 0.f;
  }
  for (int i = tid; i < F4; i += nthr) b1s[i] = b1[i];
  for (int i = tid; i < NCA_C_MAX; i += nthr) b2s[i] = i < C ? b2[i] : 0.f;
  stage_tile(tile, x + (size_t)b * C * HW, C, H, W, blockIdx.y * NCA_TILE - 1,
             blockIdx.x * NCA_TILE - 1, pad_mode, tid, nthr);
  __syncthreads();

  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  const bool inside = px < W && py < H;
  const int centre = (threadIdx.y + 1) * NCA_HALO + threadIdx.x + 1;
  float xc[NCA_C_MAX];
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c)
    xc[c] = c < C ? tile[c * NCA_HALO * NCA_HALO + centre] : 0.f;
  if (BF16) {  // JAX rounds the raw taps, not a percept, to the compute type
    __syncthreads();
    for (int i = tid; i < nt; i += nthr) tile[i] = bf16_round(tile[i]);
    __syncthreads();
  }
  if (!inside) return;
  const int pix = py * W + px;
  float pcond[NCA_CC_MAX];
#pragma unroll
  for (int j = 0; j < NCA_CC_MAX; ++j) {
    const float v = j < cc ? cond[((size_t)b * cc + j) * HW + pix] : 0.f;
    pcond[j] = BF16 ? bf16_round(v) : v;
  }

  float dx[NCA_C_MAX];
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) dx[c] = 0.f;

  const float* tpix = tile + threadIdx.y * NCA_HALO + threadIdx.x;
  for (int f = 0; f < F4; f += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float* tp = tpix + (t / 3) * NCA_HALO + (t % 3);
#pragma unroll
      for (int c = 0; c < NCA_C_MAX; ++c) {
        if (c < C) {
          const float4 w =
              *reinterpret_cast<const float4*>(w1s + (t * C + c) * F4 + f);
          const float v = tp[c * NCA_HALO * NCA_HALO];
          a.x = fmaf(w.x, v, a.x);
          a.y = fmaf(w.y, v, a.y);
          a.z = fmaf(w.z, v, a.z);
          a.w = fmaf(w.w, v, a.w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NCA_CC_MAX; ++j) {
      if (j < cc) {
        const float4 w =
            *reinterpret_cast<const float4*>(w1s + (9 * C + j) * F4 + f);
        const float v = pcond[j];
        a.x = fmaf(w.x, v, a.x);
        a.y = fmaf(w.y, v, a.y);
        a.z = fmaf(w.z, v, a.z);
        a.w = fmaf(w.w, v, a.w);
      }
    }
    const float4 bb = *reinterpret_cast<const float4*>(b1s + f);
    float hv[4] = {fmaxf(a.x + bb.x, 0.f), fmaxf(a.y + bb.y, 0.f),
                   fmaxf(a.z + bb.z, 0.f), fmaxf(a.w + bb.w, 0.f)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = BF16 ? bf16_round(hv[i]) : hv[i];
      const float* w2r = w2s + (f + i) * NCA_C_MAX;
#pragma unroll
      for (int g = 0; g < NCA_C_MAX / 4; ++g) {
        if (4 * g < C) {
          const float4 w = *reinterpret_cast<const float4*>(w2r + 4 * g);
          dx[4 * g + 0] = fmaf(w.x, h, dx[4 * g + 0]);
          dx[4 * g + 1] = fmaf(w.y, h, dx[4 * g + 1]);
          dx[4 * g + 2] = fmaf(w.z, h, dx[4 * g + 2]);
          dx[4 * g + 3] = fmaf(w.w, h, dx[4 * g + 3]);
        }
      }
    }
  }

  const bool on = (mask_bits(seed, (uint32_t)b, step, (uint32_t)pix) >> 8) >= thr;
  float* ob = out + (size_t)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) {
    if (c < C) ob[(size_t)c * HW] = on ? xc[c] + (dx[c] + b2s[c]) : xc[c];
  }
}

template <bool BF16, bool MS, typename T = float, bool CHAIN = false>
static void launch(dim3 grid, size_t smem, cudaStream_t s, const T* x, T* out,
                   const T* cond, const float* w1, const float* b1, const float* w2,
                   const float* b2, int C, int H, int W, int cc, int F4, int pad_mode,
                   unsigned int seed, unsigned int step, unsigned int thr) {
  cudaFuncSetAttribute(nca_step_kernel<BF16, MS, T, CHAIN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nca_step_kernel<BF16, MS, T, CHAIN><<<grid, NS_THREADS, smem, s>>>(
      x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4, pad_mode, seed, step, thr);
}

template <bool BF16>
static void launch_mat(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                       const float* x, float* out, const float* cond,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, int C, int H, int W, int cc, int F4,
                       int pad_mode, unsigned int seed, unsigned int step,
                       unsigned int thr) {
  // W_eff alone is up to 148 x 128 floats (75.8 KB): past the 48 KB default,
  // so the dynamic shared memory limit is raised for every launch
  cudaFuncSetAttribute(nca_step_mat_kernel<BF16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nca_step_mat_kernel<BF16><<<grid, block, smem, s>>>(
      x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4, pad_mode, seed, step, thr);
}

static bool bad_sizes(int C, int cc, int F4, int pad_mode) {
  return C < 1 || C > NCA_C_MAX || cc < 0 || cc > NCA_CC_MAX || F4 < 4 ||
         F4 > NCA_F_MAX || F4 % 4 != 0 || pad_mode < 0 || pad_mode > 2;
}

// nca_step_mat's shared memory (P = 9C + cc)
static size_t mat_smem(int P, int C, int F4) {
  return sizeof(float) * ((size_t)P * F4 + (size_t)F4 * NCA_C_MAX + F4 + NCA_C_MAX +
                          (size_t)C * NCA_HALO * NCA_HALO);
}

static size_t step_smem(int C, int cc, int F4, bool ms, bool chain) {
  return sizeof(float) *
         step_floats(C, cc, F4, ms, chain, !chain || chain_w1_staged(C, cc, F4, ms));
}

static dim3 step_grid(int B, int H, int W) {
  return dim3((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE, B);
}

template <typename K>
static int blocks_per_sm(K kernel, size_t smem) {
  int n = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NS_THREADS, smem);
  return n;
}

extern "C" {

// Sizes past these limits are refused by the wrapper before launch.
int nca_step_limits(int* c_max, int* cc_max, int* f_max) {
  *c_max = NCA_C_MAX;
  *cc_max = NCA_CC_MAX;
  *f_max = NCA_F_MAX;
  return 0;
}

// One step: x [B, C, H, W] -> out [B, C, H, W] (distinct buffers). cond is
// [B, cc, H, W] or null when cc == 0. w1 [4C + cc, F4] (16-byte aligned),
// b1 [F4], w2 [F4, C], b2 [C], all float32, F4 a multiple of 4. pad_mode:
// 0 circular, 1 replicate, 2 zeros. ms: perception_scales (0, 1)
// (nca_step_ms; even H and W) instead of (0,). chain: the chain form (the
// training pair's forward) instead of the tensor-core form. Returns the
// launch's cudaGetLastError().
int nca_step_launch(const float* x, float* out, const float* cond,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, int B, int C, int H, int W, int cc,
                    int F4, int pad_mode, int bf16, int ms, int chain,
                    unsigned int seed, unsigned int step, unsigned int thr,
                    void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode) || (ms && (H % 2 || W % 2)) ||
      reinterpret_cast<uintptr_t>(w1) % 16 != 0)  // W1 rows go by cp.async
    return (int)cudaErrorInvalidValue;
  const dim3 grid = step_grid(B, H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = step_smem(C, cc, F4, ms, chain);
  if (chain) {
    if (bf16 && ms)
      launch<true, true, float, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H, W,
                                      cc, F4, pad_mode, seed, step, thr);
    else if (bf16)
      launch<true, false, float, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H,
                                       W, cc, F4, pad_mode, seed, step, thr);
    else if (ms)
      launch<false, true, float, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H,
                                       W, cc, F4, pad_mode, seed, step, thr);
    else
      launch<false, false, float, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H,
                                        W, cc, F4, pad_mode, seed, step, thr);
  } else if (bf16 && ms) {
    launch<true, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4,
                       pad_mode, seed, step, thr);
  } else if (bf16) {
    launch<true, false>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4,
                        pad_mode, seed, step, thr);
  } else if (ms) {
    launch<false, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4,
                        pad_mode, seed, step, thr);
  } else {
    launch<false, false>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4,
                         pad_mode, seed, step, thr);
  }
  return (int)cudaGetLastError();
}

// The bf16-state form of one step, perception_scales (0,): x, out and cond
// are bfloat16 (cond null when cc == 0), everything else as nca_step_launch
// (always the tensor-core form).
int nca_step_bf16_state_launch(const void* x, void* out, const void* cond,
                               const float* w1, const float* b1,
                               const float* w2, const float* b2, int B, int C,
                               int H, int W, int cc, int F4, int pad_mode,
                               int bf16, unsigned int seed, unsigned int step,
                               unsigned int thr, void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode) || reinterpret_cast<uintptr_t>(w1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(C, cc, F4, false, false);
  const dim3 grid = step_grid(B, H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* cb = static_cast<const bf*>(cond);
  bf* ob = static_cast<bf*>(out);
  if (bf16)
    launch<true, false, bf>(grid, smem, s, xb, ob, cb, w1, b1, w2, b2, C, H, W, cc, F4,
                            pad_mode, seed, step, thr);
  else
    launch<false, false, bf>(grid, smem, s, xb, ob, cb, w1, b1, w2, b2, C, H, W, cc, F4,
                             pad_mode, seed, step, thr);
  return (int)cudaGetLastError();
}

// The folded-stencil step (nca_step_mat), perception_scales (0,): w1 is
// W_eff [9C + cc, F4] (stencil_folded_w1, padded to F4), everything else as
// nca_step_launch.
int nca_step_mat_launch(const float* x, float* out, const float* cond,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, int B, int C, int H, int W, int cc,
                        int F4, int pad_mode, int bf16, unsigned int seed,
                        unsigned int step, unsigned int thr, void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode)) return (int)cudaErrorInvalidValue;
  const size_t smem = mat_smem(9 * C + cc, C, F4);
  const dim3 grid = step_grid(B, H, W);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_mat<true>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C, H,
                     W, cc, F4, pad_mode, seed, step, thr);
  else
    launch_mat<false>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C, H,
                      W, cc, F4, pad_mode, seed, step, thr);
  return (int)cudaGetLastError();
}

// Blocks an SM of a step form at these widths (cudaOccupancy...), with its
// dynamic shared memory in *smem_bytes: form 0 the tensor-core nca_step, 1
// its bf16-state form, 2 the chain form (ms, bf16 as nca_step_launch).
int nca_step_occupancy(int C, int cc, int F4, int bf16, int ms, int form,
                       int* blocks, int* smem_bytes) {
  if (bad_sizes(C, cc, F4, 0)) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(C, cc, F4, ms, form == 2);
  *smem_bytes = (int)smem;
  using bf = __nv_bfloat16;
  if (form == 1)
    *blocks = bf16 ? blocks_per_sm(nca_step_kernel<true, false, bf>, smem)
                   : blocks_per_sm(nca_step_kernel<false, false, bf>, smem);
  else if (form == 2)
    *blocks = bf16 ? (ms ? blocks_per_sm(nca_step_kernel<true, true, float, true>, smem)
                         : blocks_per_sm(nca_step_kernel<true, false, float, true>, smem))
                   : (ms ? blocks_per_sm(nca_step_kernel<false, true, float, true>, smem)
                         : blocks_per_sm(nca_step_kernel<false, false, float, true>, smem));
  else
    *blocks = bf16 ? (ms ? blocks_per_sm(nca_step_kernel<true, true>, smem)
                         : blocks_per_sm(nca_step_kernel<true, false>, smem))
                   : (ms ? blocks_per_sm(nca_step_kernel<false, true>, smem)
                         : blocks_per_sm(nca_step_kernel<false, false>, smem));
  return (int)cudaGetLastError();
}

}  // extern "C"
