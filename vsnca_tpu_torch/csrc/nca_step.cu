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
// nca_step_mat — nca_step_kernel<BF16, false, float, CHAIN, true> —
// replaces _make_kernel_roll(mat_stencil=True) (pallas_step.py :175, algo
// "mat"): the stencils are folded into the first layer (stencil_folded_w1
// :148), z1 = W_eff^T [the 3x3 taps of every channel, 9C values | cond] +
// b1, then the same ReLU, second layer, mask and residual. Per pixel that is
// 2*((9C + cc)*F + F*C) FLOP (c12/fc96/cc3: 23.6 kFLOP, about twice
// nca_step's; 1.548 GFLOP a 256^2 step): 23 us at the float32 CUDA-core
// rate, while the bytes bound the step at 2.1 us and the products take
// 1.6 us in bf16 and 9.4 us in split TF32 on the tensor cores. The form
// follows the compute type (fused_step.py::chain_form says why):
//   * float32 compute, the tensor-core form, an implicit GEMM: the block
//     stages nca_step's C x 18 x 18 halo tile (padding rule and cp.async as
//     nca_step's), the conditioning's tile and W_eff, and z1_mma reads the A
//     fragments straight from the tiles through a tap view
//     (nca_mma.cuh::Taps; no column buffer), then the bias, the relu and
//     the second layer, mask and residual as in the tensor-core nca_step;
//   * bf16 compute, the chain form (CHAIN, BF16 only): the plain version's
//     order (z1 over W_eff's rows in order, then the bias; dx over the units
//     in order), a thread 8 units x 4 pixels, 6 shared-memory reads a row
//     feeding 32 FMAs. It rounds where JAX does: W_eff after the float32
//     fold (by the wrapper), the raw taps (not a percept, in place in the
//     tile) and the hidden activations.
// nca_step_mat_launch's tc takes the tensor-core form under bf16 compute as
// well (its drift against the plain version is reported, not served).
// Shared memory at c12/fc96/cc3: W_eff 44.4 KB + W2, biases 8.1 KB +
// offsets and tiles 19.9 KB = 72.4 KB, and the chain form's chunk 32.8 KB
// more; two blocks an SM.

#include "nca_common.cuh"
#include "nca_mma.cuh"

#define NS_THREADS (NCA_TILE * NCA_TILE)  // pixels of a block, one thread each
#define NS_FC 32                          // hidden units a chunk (tensor-core form)
#define NS_LDW2 20                        // stride of W2's rows in shared memory
// Dynamic shared memory of a block when two blocks share an SM: (the SM's
// 228 KB less 1 KB reserved a block) / 2.
#define NS_SMEM_TWO ((233472 / 2) - 1024)

// The depth rows of a step: the percept [4C + cc], or with mat the folded
// stencil's taps [9C + cc].
__host__ __device__ inline int step_rows(int C, int cc, bool mat) {
  return (mat ? 9 : 4) * C + cc;
}

// nca_step_kernel's shared memory in floats (see its layout): the chain
// form adds hs, and keeps W1 out of it when two blocks would not fit with
// it (chain_w1_staged).
__host__ __device__ inline size_t step_floats(int C, int cc, int F4, bool ms, bool chain,
                                              bool w1, bool mat = false) {
  const size_t P = step_rows(C, cc, mat), FP = (F4 + NS_FC - 1) / NS_FC * NS_FC;
  size_t tiles = (size_t)C * NCA_HALO * NCA_HALO;
  if (ms) tiles += (size_t)C * (NCA_HHALO * NCA_HHALO + 4 * NCA_HFOOT * NCA_HFOOT);
  const size_t cols = P * NS_THREADS;  // > tiles: 4C x 256 against <= 868 C
  // mat: koff [P] (ints, rounded up to 4) and the tile [C + cc, 18, 18]
  const size_t rows = mat ? ((P + 3) & ~(size_t)3) + (size_t)(C + cc) * NCA_HALO * NCA_HALO
                          : (cols > tiles ? cols : tiles);
  return (w1 ? P * (FP + 4) : 0) + FP * NS_LDW2 + 2 * FP + NCA_C_MAX + NS_THREADS + rows +
         (chain ? NS_FC * NS_THREADS : 0);
}

// Whether the chain form stages W1 in shared memory (two blocks an SM
// still fit) or reads it through L1.
__host__ __device__ inline bool chain_w1_staged(int C, int cc, int F4, bool ms,
                                                bool mat = false) {
  return step_floats(C, cc, F4, ms, true, true, mat) * sizeof(float) <= NS_SMEM_TWO;
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
//
// MAT (nca_step_mat, see the file header): W1 is W_eff [9C + cc, F4], and
// in place of ps the block keeps koff [9C + cc] (ints; rounded up to 4) and
// tile [C + cc, 18, 18]: the state's halo tile, then the conditioning's
// 16 x 16 pixels at the centre of each 18 x 18 plane (zeros around them),
// rounded to bf16 in place under bf16 compute. Depth row k of pixel m is
// tile[koff[k] + (m / 16) * 18 + m % 16] (nca_mma.cuh::Taps): koff[k] is
// c * 324 + di * 18 + dj for k = (di * 3 + dj) * C + c, and the centre of
// conditioning plane j for k = 9C + j. The MLP then runs on those rows where
// the other forms read percept columns; w1n and pmx go unused (no
// certificate: no backward recomputes this step). MAT with float only,
// neither MS nor BSTATE; MAT with CHAIN only with BF16.
template <bool BF16, bool MS, typename T = float, bool CHAIN = false, bool MAT = false>
__global__ void __launch_bounds__(NS_THREADS, 2)
nca_step_kernel(const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ cond, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int C, int H, int W, int cc,
                int F4, int pad_mode, uint32_t seed, uint32_t step,
                uint32_t thr) {
  constexpr bool BSTATE = sizeof(T) == 2;
  static_assert(!MAT || (!MS && !BSTATE), "the folded-stencil form: scales (0,), f32 state");
  static_assert(!(MAT && CHAIN) || BF16, "the folded-stencil chain form: bf16 compute");
  extern __shared__ __align__(16) float smem[];
  const int P = step_rows(C, cc, MAT);
  const int FP = (F4 + NS_FC - 1) / NS_FC * NS_FC, LDW = FP + 4;
  const bool staged = !CHAIN || chain_w1_staged(C, cc, F4, MS, MAT);
  float* w1s = smem;
  float* w2s = w1s + (staged ? P * LDW : 0);
  float* b1s = w2s + FP * NS_LDW2;
  float* w1n = b1s + FP;
  float* b2s = w1n + FP;
  float* pmx = b2s + NCA_C_MAX;
  float* ps = pmx + NS_THREADS;
  int* koff = reinterpret_cast<int*>(ps);
  float* tile = MAT ? ps + ((P + 3) & ~3) : ps;
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
    if constexpr (MAT) {
      // the conditioning at the centre of its planes, and the tap offsets
      float* ct = tile + C * NCA_HALO * NCA_HALO;
      for (int i = tid; i < cc * NCA_HALO * NCA_HALO; i += NS_THREADS) {
        const int j = i / (NCA_HALO * NCA_HALO);
        const int r = (i / NCA_HALO) % NCA_HALO, q = i % NCA_HALO;
        const int gy = blockIdx.y * NCA_TILE + r - 1, gx = blockIdx.x * NCA_TILE + q - 1;
        if (r >= 1 && r <= NCA_TILE && q >= 1 && q <= NCA_TILE && gy < H && gx < W)
          cp_async4(ct + i, cond + ((size_t)b * cc + j) * HW + gy * W + gx);
        else
          ct[i] = 0.f;
      }
      for (int k = tid; k < P; k += NS_THREADS) {
        const int tap = k / C, c = k - tap * C, j = k - 9 * C;
        koff[k] = tap < 9 ? c * NCA_HALO * NCA_HALO + (tap / 3) * NCA_HALO + tap % 3
                          : (C + j) * NCA_HALO * NCA_HALO + NCA_HALO + 1;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the weights and the tiles (the half percept; MAT: cond, koff)

  const Cols cols{ps, NS_THREADS, -1};
  const Taps taps{tile, koff, NCA_HALO};
  if constexpr (MAT) {
    if constexpr (BF16) {  // JAX rounds the raw taps, not a percept, to the compute type
      for (int i = tid; i < (C + cc) * NCA_HALO * NCA_HALO; i += NS_THREADS)
        tile[i] = bf16_round(tile[i]);
      __syncthreads();  // the rounded taps
    }
  } else {
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
  }

  if constexpr (CHAIN) {
    // z1 as the plain version's FMA chain (rows in order, then the bias):
    // a thread takes 4 units of the chunk (its warp's) for 8 pixels 32
    // apart, a float4 of W1 (the same address across the warp, from L1) and
    // 8 percept reads feeding 32 FMAs a row; relu(z1) (rounded to bf16 under
    // bf16 compute) to hs. Then dx += W2^T h in unit order, a thread 4
    // adjacent pixels x 4 channels.
    // MAT: a thread takes 8 units (two float4s of W_eff, the same in every
    // lane of the warp) for 4 pixels, so 6 shared-memory reads feed 32 FMAs
    // a row; warps w and w + 4 share their units and split the pixels: lane
    // l, pixel i of warp half h sits in tile row 4 h + i + 8 (l / 16), column
    // l % 16, the two half-warps 8 rows (144 floats = 16 banks) apart, so a
    // tap read is free of bank conflicts.
    float* hs = MAT ? tile + (C + cc) * NCA_HALO * NCA_HALO : ps + P * NS_THREADS;
    const int warp = tid >> 5, lane = tid & 31;
    const int q = tid & 63, cg = tid >> 6;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 1
    for (int f0 = 0; f0 < FP; f0 += NS_FC) {
      if constexpr (MAT) {
        const int u0 = f0 + 8 * (warp & 3), half = warp >> 2;
        const int m0 = (4 * half + 8 * (lane >> 4)) * NCA_TILE + (lane & 15);
        const float* tp = tile + (4 * half + 8 * (lane >> 4)) * NCA_HALO + (lane & 15);
        float a[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
        }
        // W_eff's two float4s of the thread's units, from shared memory or
        // through L1 (the row stride in float4s); through L1 a unit past F4
        // reads a valid one instead (its z1 is never read), so the loop
        // carries no condition
        const int ld4 = (staged ? LDW : F4) / 4;
        const float4* wa4 = reinterpret_cast<const float4*>(
            staged ? w1s + u0 : w1 + min(u0, F4 - 4));
        const float4* wb4 = reinterpret_cast<const float4*>(
            staged ? w1s + u0 + 4 : w1 + min(u0 + 4, F4 - 4));
        // W_eff's rows in order: the 9 taps of each channel (tap < 9), then
        // the conditioning planes' centres (tap 9)
#pragma unroll 1
        for (int tap = 0, k = 0; tap < 10; ++tap) {
          const int n = tap < 9 ? C : cc;
          const float* tt = tap < 9 ? tp + (tap / 3) * NCA_HALO + tap % 3
                                    : tp + C * NCA_HALO * NCA_HALO + NCA_HALO + 1;
#pragma unroll 2
          for (int c = 0; c < n; ++c, ++k) {
            const float4 wa = wa4[k * ld4], wb = wb4[k * ld4];
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
            const float* pk = tt + c * NCA_HALO * NCA_HALO;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = pk[i * NCA_HALO];
#pragma unroll
              for (int j = 0; j < 8; ++j) a[i][j] = fmaf(wv[j], v, a[i][j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bb = b1s[u0 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float h = fmaxf(a[i][j] + bb, 0.f);
            hs[(8 * (warp & 3) + j) * NS_THREADS + m0 + i * NCA_TILE] =
                BF16 ? bf16_round(h) : h;
          }
        }
      } else {
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
      if constexpr (MAT) {
        z1_mma<BF16, 2, NS_FC / 8>(z, taps, w1s, LDW, P, m0, f0, g, t);
        z1_bias<2, NS_FC / 8>(z, b1s, f0, t);
      } else {
        z1_mma<BF16, 2, NS_FC / 8>(z, cols, w1s, LDW, P, m0, f0, g, t);
        z1_finish<2, NS_FC / 8>(z, cols, w1s, LDW, b1s, w1n, pmx, pmx, P, m0, f0, g, t);
      }
      // phase: z1 (z1_mma, then z1_finish; MAT: z1_bias)
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

template <bool BF16, bool MS, typename T = float, bool CHAIN = false, bool MAT = false>
static void launch(dim3 grid, size_t smem, cudaStream_t s, const T* x, T* out,
                   const T* cond, const float* w1, const float* b1, const float* w2,
                   const float* b2, int C, int H, int W, int cc, int F4, int pad_mode,
                   unsigned int seed, unsigned int step, unsigned int thr) {
  cudaFuncSetAttribute(nca_step_kernel<BF16, MS, T, CHAIN, MAT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nca_step_kernel<BF16, MS, T, CHAIN, MAT><<<grid, NS_THREADS, smem, s>>>(
      x, out, cond, w1, b1, w2, b2, C, H, W, cc, F4, pad_mode, seed, step, thr);
}

static bool bad_sizes(int C, int cc, int F4, int pad_mode) {
  return C < 1 || C > NCA_C_MAX || cc < 0 || cc > NCA_CC_MAX || F4 < 4 ||
         F4 > NCA_F_MAX || F4 % 4 != 0 || pad_mode < 0 || pad_mode > 2;
}

static size_t step_smem(int C, int cc, int F4, bool ms, bool chain, bool mat = false) {
  return sizeof(float) * step_floats(C, cc, F4, ms, chain,
                                     !chain || chain_w1_staged(C, cc, F4, ms, mat), mat);
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

// The folded-stencil step (nca_step_mat), perception_scales (0,), float32
// state: w1 is W_eff [9C + cc, F4] (stencil_folded_w1, padded to F4;
// 16-byte aligned), everything else as nca_step_launch. The form follows
// the compute type: the tensor-core form under float32 compute, the chain
// form under bf16 compute; tc takes the tensor-core form under bf16
// compute too.
int nca_step_mat_launch(const float* x, float* out, const float* cond,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, int B, int C, int H, int W, int cc,
                        int F4, int pad_mode, int bf16, int tc, unsigned int seed,
                        unsigned int step, unsigned int thr, void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode) || reinterpret_cast<uintptr_t>(w1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bool chain = bf16 && !tc;
  const size_t smem = step_smem(C, cc, F4, false, chain, true);
  const dim3 grid = step_grid(B, H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chain)
    launch<true, false, float, true, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C,
                                           H, W, cc, F4, pad_mode, seed, step, thr);
  else if (bf16)
    launch<true, false, float, false, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2, C,
                                            H, W, cc, F4, pad_mode, seed, step, thr);
  else
    launch<false, false, float, false, true>(grid, smem, s, x, out, cond, w1, b1, w2, b2,
                                             C, H, W, cc, F4, pad_mode, seed, step, thr);
  return (int)cudaGetLastError();
}

// Blocks an SM of a step form at these widths (cudaOccupancy...), with its
// dynamic shared memory in *smem_bytes: form 0 the tensor-core nca_step, 1
// its bf16-state form, 2 the chain form (ms, bf16 as nca_step_launch), 3
// nca_step_mat in the form its compute type takes (ms ignored).
int nca_step_occupancy(int C, int cc, int F4, int bf16, int ms, int form,
                       int* blocks, int* smem_bytes) {
  if (bad_sizes(C, cc, F4, 0)) return (int)cudaErrorInvalidValue;
  const bool mat = form == 3;
  const size_t smem = step_smem(C, cc, F4, ms && !mat, form == 2 || (mat && bf16), mat);
  *smem_bytes = (int)smem;
  using bf = __nv_bfloat16;
  if (mat)
    *blocks = bf16 ? blocks_per_sm(nca_step_kernel<true, false, float, true, true>, smem)
                   : blocks_per_sm(nca_step_kernel<false, false, float, false, true>, smem);
  else if (form == 1)
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
