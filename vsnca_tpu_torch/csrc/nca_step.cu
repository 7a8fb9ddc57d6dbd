// One DyNCA step on NCHW state, one thread per pixel — the Hopper kernel of
// the inference rollout.
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
//     ops/fused_train.py runs as nca_step launches under its segment walk.
// All compute, per step: perception [x | sobel_x | sobel_y | laplacian]
// under circular / replicate / zeros padding, append the conditioning
// channels, h = relu(W1^T p + b1), dx = W2^T h + b2, and x += dx * mask with
// mask = (u24 >= thr). The TPU kernels keep the state resident in VMEM for
// the whole rollout; this kernel keeps nothing on chip between steps, so it
// has no resident-state cap and one kernel covers them all.
//
// What bounds it on an H100: per pixel and step the MLP is 2*(P*F + F*C)
// FLOP (c12/fc96/cc3: 12.1 kFLOP) against (2C + cc) * 4 = 108 bytes of state
// and conditioning, about 112 FLOP/byte. Device memory (3.35 TB/s) bounds
// the step at ~2.1 us for 256^2; bf16 tensor cores would do the FLOPs in
// ~0.8 us, but this kernel runs the MLP as float32 FMAs on the CUDA cores
// (67 TFLOP/s peak: ~12 us for 256^2), so in practice it is bounded by its
// arithmetic and by shared-memory loads of the weights.
//
// What the design does about it: each 16x16 block stages a C x 18 x 18 state
// tile with its 1-pixel halo (resolved by the padding mode) and the whole
// weight set in shared memory, so every state element is read from device
// memory about 1.27 times per step and weights once per block. Weights are
// read as float4 along the hidden dimension (4 FMAs per shared load; the
// wrapper pads F to a multiple of 4 with zero units, which are exact
// no-ops) and are broadcast to the warp. The percept and the update live in
// registers. A tensor-core (wgmma) MLP and a persistent kernel that keeps
// the state on chip across the 24 steps of a frame are the next steps.
//
// bf16 mode rounds (round to nearest even) exactly where the TPU kernel
// casts to its compute dtype: the percept (pallas_step.py:1176), the hidden
// activations (:1379) and W1^T / W2^T (:1529-1531; rounded by the wrapper's
// weight packing). Biases, state and accumulation stay float32.
//
// The mask is a counter-based hash of (seed, batch, step, pixel), written
// once in nca_common.cuh and once in torch integer ops
// (fused_step.py::mask_bits), so the kernel and its plain version draw
// bit-identical masks, and the training backward (nca_train.cu) replays
// them.
//
// nca_step_ms — the same kernel compiled with MS = true, for
// perception_scales (0, 1) — replaces
//   * _make_kernel_roll_ms          (pallas_step.py:308, called by
//     fused_rollout_chw :731), the multiscale inference rollout,
//   * _make_fwd_kernel_flat_tiled_ms (pallas_train.py:1031, called by
//     _fwd_call_flat_tiled_ms :2144), the multiscale training forward
//     (ops/fused_train.py launches it once a step into the checkpoint).
// Per step it computes perceive_multiscale: the state's exact 2x2 mean at
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
// a step. What bounds it is the same MLP as the scale-0 step (the half
// percept adds ~0.3 kFLOP a pixel to ~12-37 kFLOP); its shared memory
// (~98 KB at c16/fc128/cc2) allows two blocks an SM.

// The bf16-state form — nca_step_kernel<BF16, false, __nv_bfloat16> —
// replaces _make_kernel (pallas_step.py:498, fused_rollout_chw with algo
// "padded" and state_dtype "bfloat16"): the state and the conditioning are
// stored as bf16 (half the bytes of a float32 step), read into float32
// registers, the stencils round every product and partial sum to bf16 as JAX
// computes them on a bf16 array, the residual add is float32, and the new
// state is rounded to bf16 on store. Its bound and its pace are those of the
// float32 step: the MLP's FMAs, not the state's bytes.
//
// nca_step_mat replaces _make_kernel_roll(mat_stencil=True) (pallas_step.py
// :175, algo "mat"): the stencils are folded into the first layer
// (stencil_folded_w1 :148), z1 = W_eff^T [the 3x3 taps of every channel, 9C
// values | cond] + b1, then the same ReLU, second layer, mask and residual.
// Per pixel that is 2*((9C + cc)*F + F*C) FLOP (c12/fc96/cc3: 23.6 kFLOP,
// about twice nca_step's), so it is bounded by the same float32 FMAs, twice
// over; the TPU kernel moved the stencil arithmetic onto its matrix unit, and
// a tensor-core (implicit-GEMM) form of this kernel is where that pays here.
// It reuses nca_step's C x 18 x 18 halo tile and padding rule and reads the
// taps from that shared tile (not registers: 9C taps would not fit beside
// the accumulators). W_eff is up to 148 x 128 floats, 75.8 KB, past the
// 48 KB default of shared memory: the launch raises the block's dynamic
// shared-memory limit with cudaFuncSetAttribute. Under bf16 compute it
// rounds where JAX does: W_eff after the float32 fold (by the wrapper), the
// raw taps (not a percept) and the hidden activations.

#include "nca_common.cuh"

// Shared memory, all float32, in this order (every part a multiple of 4
// floats, so each starts 16-byte aligned):
//   w1s [P, F4]     P = 4*C + cc rows in the percept's block order
//   w2s [F4, C_MAX] zero columns past C
//   b1s [F4], b2s [C_MAX]
//   tile [C, 18, 18]
//   MS only: htile [C, 12, 12], hp [4C, 10, 10]
// T is the state's (and the conditioning's) storage type: float, or
// __nv_bfloat16 for the bf16-state form (see the header; MS only with float).
template <bool BF16, bool MS, typename T = float>
__global__ void __launch_bounds__(NCA_TILE * NCA_TILE)
nca_step_kernel(const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ cond, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int C, int H, int W, int cc,
                int F4, int pad_mode, uint32_t seed, uint32_t step,
                uint32_t thr) {
  constexpr bool BSTATE = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int P = 4 * C + cc;
  float* w1s = smem;
  float* w2s = w1s + P * F4;
  float* b1s = w2s + F4 * NCA_C_MAX;
  float* b2s = b1s + F4;
  float* tile = b2s + NCA_C_MAX;
  float* htile = tile + C * NCA_HALO * NCA_HALO;
  float* hp = htile + C * NCA_HHALO * NCA_HHALO;

  const int tid = threadIdx.y * NCA_TILE + threadIdx.x;
  const int nthr = NCA_TILE * NCA_TILE;
  const int b = blockIdx.z;
  const int HW = H * W;

  for (int i = tid; i < P * F4; i += nthr) w1s[i] = w1[i];
  for (int i = tid; i < F4 * NCA_C_MAX; i += nthr) {
    const int f = i / NCA_C_MAX, c = i % NCA_C_MAX;
    w2s[i] = c < C ? w2[f * C + c] : 0.f;
  }
  for (int i = tid; i < F4; i += nthr) b1s[i] = b1[i];
  for (int i = tid; i < NCA_C_MAX; i += nthr) b2s[i] = i < C ? b2[i] : 0.f;

  const T* xb = x + (size_t)b * C * HW;
  stage_tile(tile, xb, C, H, W, blockIdx.y * NCA_TILE - 1,
             blockIdx.x * NCA_TILE - 1, pad_mode, tid, nthr);
  if constexpr (MS) {
    half_percept(htile, hp, xb, C, H, W, blockIdx.y, blockIdx.x, pad_mode, tid,
                 nthr);
  } else {
    __syncthreads();
  }

  const int px = blockIdx.x * NCA_TILE + threadIdx.x;
  const int py = blockIdx.y * NCA_TILE + threadIdx.y;
  if (px >= W || py >= H) return;
  const int pix = py * W + px;
  int fi = 0, fin = 0, fj = 0, fjn = 0;
  if (MS) {
    upsample_taps(blockIdx.y, threadIdx.y, H, fi, fin);
    upsample_taps(blockIdx.x, threadIdx.x, W, fj, fjn);
  }
  const int nf = NCA_HFOOT * NCA_HFOOT;

  // Percept in registers: pc[k][c] is block k (raw, sx, sy, lap) of
  // channel c; every index is a compile-time constant after unrolling.
  float pc[4][NCA_C_MAX];
  float pcond[NCA_CC_MAX];
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) {
    if (c < C) {
      const float* t =
          tile + (c * NCA_HALO + threadIdx.y) * NCA_HALO + threadIdx.x;
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
#pragma unroll
  for (int j = 0; j < NCA_CC_MAX; ++j)
    pcond[j] = j < cc ? to_float(cond[((size_t)b * cc + j) * HW + pix]) : 0.f;
  if (BF16) {
#pragma unroll
    for (int c = 0; c < NCA_C_MAX; ++c) {
#pragma unroll
      for (int k = 0; k < 4; ++k) pc[k][c] = bf16_round(pc[k][c]);
    }
#pragma unroll
    for (int j = 0; j < NCA_CC_MAX; ++j) pcond[j] = bf16_round(pcond[j]);
  }

  float dx[NCA_C_MAX];
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) dx[c] = 0.f;

  for (int f = 0; f < F4; f += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < NCA_C_MAX; ++c) {
        if (c < C) {
          const float4 w =
              *reinterpret_cast<const float4*>(w1s + (k * C + c) * F4 + f);
          const float v = pc[k][c];
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
            *reinterpret_cast<const float4*>(w1s + (4 * C + j) * F4 + f);
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
  T* ob = out + (size_t)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < NCA_C_MAX; ++c) {
    if (c < C) {
      // the state, not pc[0][c], which bf16 mode has rounded; the residual
      // add is float32 and a bf16 state is rounded on store
      const float xc =
          tile[(c * NCA_HALO + threadIdx.y + 1) * NCA_HALO + threadIdx.x + 1];
      ob[(size_t)c * HW] = from_float<T>(on ? xc + (dx[c] + b2s[c]) : xc);
    }
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

template <bool BF16, bool MS, typename T = float>
static void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                   const T* x, T* out, const T* cond, const float* w1,
                   const float* b1, const float* w2, const float* b2, int C,
                   int H, int W, int cc, int F4, int pad_mode,
                   unsigned int seed, unsigned int step, unsigned int thr) {
  cudaFuncSetAttribute(nca_step_kernel<BF16, MS, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nca_step_kernel<BF16, MS, T><<<grid, block, smem, s>>>(
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

static size_t step_smem(int P, int C, int F4) {
  return sizeof(float) * ((size_t)P * F4 + (size_t)F4 * NCA_C_MAX + F4 +
                          NCA_C_MAX + (size_t)C * NCA_HALO * NCA_HALO);
}

static dim3 step_grid(int B, int H, int W) {
  return dim3((W + NCA_TILE - 1) / NCA_TILE, (H + NCA_TILE - 1) / NCA_TILE, B);
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
// [B, cc, H, W] or null when cc == 0. w1 [4C + cc, F4], b1 [F4], w2 [F4, C],
// b2 [C], all float32, F4 a multiple of 4. pad_mode: 0 circular,
// 1 replicate, 2 zeros. ms: perception_scales (0, 1) (nca_step_ms; even H
// and W) instead of (0,). Returns the launch's cudaGetLastError().
int nca_step_launch(const float* x, float* out, const float* cond,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, int B, int C, int H, int W, int cc,
                    int F4, int pad_mode, int bf16, int ms, unsigned int seed,
                    unsigned int step, unsigned int thr, void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode) || (ms && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  size_t smem = step_smem(4 * C + cc, C, F4);
  if (ms)
    smem += sizeof(float) * (size_t)C *
            (NCA_HHALO * NCA_HHALO + 4 * NCA_HFOOT * NCA_HFOOT);
  const dim3 grid = step_grid(B, H, W);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && ms)
    launch<true, true>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C,
                       H, W, cc, F4, pad_mode, seed, step, thr);
  else if (bf16)
    launch<true, false>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C,
                        H, W, cc, F4, pad_mode, seed, step, thr);
  else if (ms)
    launch<false, true>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C,
                        H, W, cc, F4, pad_mode, seed, step, thr);
  else
    launch<false, false>(grid, block, smem, s, x, out, cond, w1, b1, w2, b2, C,
                         H, W, cc, F4, pad_mode, seed, step, thr);
  return (int)cudaGetLastError();
}

// The bf16-state form of one step, perception_scales (0,): x, out and cond
// are bfloat16 (cond null when cc == 0), everything else as nca_step_launch.
int nca_step_bf16_state_launch(const void* x, void* out, const void* cond,
                               const float* w1, const float* b1,
                               const float* w2, const float* b2, int B, int C,
                               int H, int W, int cc, int F4, int pad_mode,
                               int bf16, unsigned int seed, unsigned int step,
                               unsigned int thr, void* stream) {
  if (bad_sizes(C, cc, F4, pad_mode)) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(4 * C + cc, C, F4);
  const dim3 grid = step_grid(B, H, W);
  const dim3 block(NCA_TILE, NCA_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* cb = static_cast<const bf*>(cond);
  bf* ob = static_cast<bf*>(out);
  if (bf16)
    launch<true, false, bf>(grid, block, smem, s, xb, ob, cb, w1, b1, w2, b2,
                            C, H, W, cc, F4, pad_mode, seed, step, thr);
  else
    launch<false, false, bf>(grid, block, smem, s, xb, ob, cb, w1, b1, w2, b2,
                             C, H, W, cc, F4, pad_mode, seed, step, thr);
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
  const size_t smem = step_smem(9 * C + cc, C, F4);
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

}  // extern "C"
