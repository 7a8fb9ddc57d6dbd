// Warp-level tensor-core products for the DyNCA and ConditionedNCA kernels
// (nca_step.cu, nca_train.cu, nca_cnca.cu): mma.sync m16n8k8 in TF32 and
// m16n8k16 in bf16, both with float32 accumulators.
//
// float32 compute runs split TF32 ("3xTF32"): each operand a = a_hi + a_lo,
// a_hi rounded to TF32 as cvt.rna rounds (to nearest, ties away), a_lo the
// rest truncated to TF32, and
// a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, accumulated in float32; the
// dropped a_lo*b_lo and the rounding of a_lo leave ~2^-22 of each product.
// Each depth block of 16 sums into fresh accumulators that ordinary float32
// adds take into the running sum (mma_frag says why). Measured on
// the H100 against the plain version, the ConditionedNCA pair's 24-step
// gradients: 1.7e-6 of their largest element accumulating in the tensor
// core, 5.7e-7 with the fresh blocks (the first design's float32 FMAs:
// 2.7e-7). bf16 compute feeds the operands the kernels have already rounded
// to bf16, so every product is exact, and accumulates in the tensor core.
//
// Fragment coordinates (lane = 4 g + t), rows m, columns n, depth k:
//   C (16 x 8, float32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   TF32 A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   TF32 B (8 x 8):  b0 (t, g), b1 (t+4, g)
//   bf16 A (16 x 16): a0 (g, 2t | 2t+1), a1 (g+8, 2t | 2t+1),
//                     a2 (g, 2t+8 | 2t+9), a3 (g+8, 2t+8 | 2t+9)
//   bf16 B (16 x 8):  b0 (2t | 2t+1, g), b1 (2t+8 | 2t+9, g)
// The depth of a product is a summation index, so a kernel may map the
// instruction's k slots onto its data in any order, as long as A and B use
// the same map. Two maps are used:
//   "strided" over a depth block of 16 (pixels, or channels): the thread's
//     four k values are t, t+4, t+8, t+12 — TF32 takes (t, t+4) and
//     (t+8, t+12) as two k-steps; bf16 packs (t | t+4) and (t+8 | t+12). The
//     shared-memory reads are then the same in both modes.
//   "paired" over the columns of a C fragment (a product whose A is the
//     previous product's output, still in registers): TF32 k-step j takes
//     units (2t, 2t+1) of n-tile j as its (t, t+4); bf16 takes n-tiles j and
//     j+1 in their natural order. See FragA. The first layer z1 = P^T W1
//     (z1_mma) uses the same paired order over the percept rows, k = 2t,
//     2t+1, 2t+8, 2t+9, read from shared memory: with both row strides
//     = 4 mod 32 every read is free of bank conflicts.
//
// z1 and its relu gates. The DyNCA training forward (nca_step's exact form)
// computes z1 as a float32 FMA chain over the percept rows in order, the
// plain version's bits; the backward (nca_bwd_mlp) and the rollout step's
// tensor-core form share one z1 function (z1_mma + z1_finish): the split
// TF32 or bf16 product above, then the bias, then a certificate — where
// |z1 + b1| is below Z1_KAPPA * max_k |p_k| * sum_k |W1[k][u]|, a bound on
// the distance between the product and the chain, the element is
// recomputed as the chain (z1_chain). Every relu gate the backward uses is
// therefore the forward's, whichever form ran the forward.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// x = hi + lo as TF32 operands: hi is x rounded to TF32 (round to nearest,
// ties away: cvt.rna.tf32.f32's rounding, done with integer operations at
// the full instruction rate rather than by the conversion unit), lo = x - hi
// (exact in float32) with its low 13 bits cleared, as the tensor core would
// truncate them.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A operand over a depth block of 16, converted once and used against
// any number of B operands: bf16 packs it into h[0..3]; TF32 splits it into
// h (hi) and l (lo), h[0..3] / l[0..3] the first k-step, h[4..7] / l[4..7]
// the second.
template <bool BF16>
struct FragA {
  uint32_t h[8], l[8];

  // "strided" map: a[8] holds the thread's A values at (g, t), (g+8, t),
  // (g, t+4), (g+8, t+4), (g, t+8), (g+8, t+8), (g, t+12), (g+8, t+12).
  __device__ __forceinline__ void strided(const float a[8]) {
    if constexpr (BF16) {
      h[0] = pack_bf16(a[0], a[2]);
      h[1] = pack_bf16(a[1], a[3]);
      h[2] = pack_bf16(a[4], a[6]);
      h[3] = pack_bf16(a[5], a[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) tf32_split(a[i], h[i], l[i]);
    }
  }

  // "paired" map: the 16 x 16 A is two C fragments, ca (columns 0-7) and
  // cb (8-15).
  __device__ __forceinline__ void paired(const float ca[4], const float cb[4]) {
    if constexpr (BF16) {
      h[0] = pack_bf16(ca[0], ca[1]);
      h[1] = pack_bf16(ca[2], ca[3]);
      h[2] = pack_bf16(cb[0], cb[1]);
      h[3] = pack_bf16(cb[2], cb[3]);
    } else {
      // TF32 k-steps over ca then cb: slots t, t+4 are units 2t, 2t+1
      const float a[8] = {ca[0], ca[2], ca[1], ca[3], cb[0], cb[2], cb[1], cb[3]};
#pragma unroll
      for (int i = 0; i < 8; ++i) tf32_split(a[i], h[i], l[i]);
    }
  }
};

// B's four values split once for any number of A operands: bf16 packs
// them into h[0..1]; TF32 splits them into h (hi) and l (lo), [0..1] the
// first k-step, [2..3] the second.
template <bool BF16>
struct FragB {
  uint32_t h[4], l[4];

  __device__ __forceinline__ void set(const float b[4]) {
    if constexpr (BF16) {
      h[0] = pack_bf16(b[0], b[1]);
      h[1] = pack_bf16(b[2], b[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32_split(b[i], h[i], l[i]);
    }
  }
};

// d += A B over a depth block of 16, B's four values b[4] at the thread's
// k = t, t+4, t+8, t+12 (strided map) or 2t, 2t+1, 2t+8, 2t+9 (paired).
// bf16: one m16n8k16, accumulated in the tensor core. TF32: the two
// k-steps' a_lo b_hi + a_hi b_lo into one fresh accumulator and a_hi b_hi
// into another (two short chains, not one of six), then d += (small + big)
// by ordinary float32 adds: the tensor core's float32 accumulation does not
// round to nearest (it truncates as it aligns), which over a depth of 128 or
// 256 pixels drifts by several float32 ulps, so no sum runs in it past one
// depth block.
template <bool BF16>
__device__ __forceinline__ void mma_frag(float d[4], const FragA<BF16>& A,
                                         const FragB<BF16>& B) {
  if constexpr (BF16) {
    mma_bf16(d, A.h, B.h);
  } else {
    float ss[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(ss, A.l, B.h);
    mma_tf32(sb, A.h, B.h);
    mma_tf32(ss, A.h, B.l);
    mma_tf32(sb, A.h + 4, B.h + 2);
    mma_tf32(ss, A.l + 4, B.h + 2);
    mma_tf32(ss, A.h + 4, B.l + 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += ss[i] + sb[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void mma_frag(float d[4], const FragA<BF16>& A,
                                         const float b[4]) {
  FragB<BF16> B;
  B.set(b);
  mma_frag<BF16>(d, A, B);
}

// d[j] += A B_j^T for j < n (n <= NT, the same for the whole warp), where
// A is 16 rows at a and B_j the 8 rows at b + 8 j ld of column arrays (row
// stride ld floats, ld = 4 mod 32 so that the reads are free of bank
// conflicts), summed over K columns (a multiple of 16, the depth in the
// strided map) from column k0. A is loaded and converted once a depth block
// for all n products.
template <bool BF16, int NT, int K>
__device__ __forceinline__ void mma_rows(float d[NT][4], const float* a, const float* b,
                                         int n, int ld, int k0, int g, int t) {
  a += g * ld + t + k0;
  b += g * ld + t + k0;
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    float av[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[2 * q] = a[k + 4 * q];
      av[2 * q + 1] = a[8 * ld + k + 4 * q];
    }
    FragA<BF16> fa;
    fa.strided(av);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n) {
        float bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = b[8 * j * ld + k + 4 * q];
        mma_frag<BF16>(d[j], fa, bv);
      }
    }
  }
}

// ------------------------------------------------------------------ z1

// 2^-16: bounds the distance between z1_mma's sum and the FMA chain's,
// relative to S = sum_k |p_k W1[k][u]| <= max_k |p_k| * sum_k |W1[k][u]|:
// the chain is within P * 2^-24 / (1 - P * 2^-24) S of the exact sum
// (4.1e-6 S at P = 68), split TF32 within ~3 * 2^-22 S a product plus the
// tensor core's truncating additions and the block adds (< 3e-6 S), bf16
// within the latter alone; 2^-16 = 1.5e-5 leaves a factor of two.
#define Z1_KAPPA 1.52587890625e-05f

// Percept columns in shared memory: entry (k, m) — percept row k of the
// block's pixel m — at k * ld + (m ^ (swz & ((k & 7) << 2))): swz = -1
// swizzles rows of 256 floats so that the paired reads stay free of bank
// conflicts; swz = 0 reads rows padded to ld = 4 mod 32.
struct Cols {
  const float* p;
  int ld, swz;
  __device__ __forceinline__ int idx(int k, int m) const {
    return k * ld + (m ^ (swz & ((k & 7) << 2)));
  }
  __device__ __forceinline__ float at(int k, int m) const { return p[idx(k, m)]; }
};

// The folded-stencil step's depth rows read in place (nca_step.cu's mat
// form): entry (k, m) is t[koff[k] + (m / 16) * ld + m % 16], a 16-pixel-wide
// block's pixel m in a row-major tile whose rows are ld floats apart; koff[k]
// puts depth row k on its channel's plane and 3x3 tap (or on a conditioning
// plane's centre). z1_block reads any type with this at().
struct Taps {
  const float* t;
  const int* koff;
  int ld;
  __device__ __forceinline__ float at(int k, int m) const {
    return t[koff[k] + (m >> 4) * ld + (m & 15)];
  }
};

// One depth block of z1_mma from row k0: rows past P read as zeros (TAIL).
// A is the accessor of the depth rows (Cols, Taps).
template <bool BF16, int MT, int NT, bool TAIL, typename A>
__device__ __forceinline__ void z1_block(float d[MT][NT][4], A ps, const float* w1s,
                                         int ldw, int P, int m0, int u0, int k0, int g,
                                         int t) {
  const int k = k0 + 2 * t;
  FragA<BF16> fa[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + 16 * i + g;
    float av[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k + (q & 1) + 8 * (q >> 1);
      const bool in = !TAIL || kk < P;
      av[2 * q] = in ? ps.at(kk, m) : 0.f;
      av[2 * q + 1] = in ? ps.at(kk, m + 8) : 0.f;
    }
    fa[i].strided(av);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k + (q & 1) + 8 * (q >> 1);
      bv[q] = (!TAIL || kk < P) ? w1s[kk * ldw + u0 + 8 * j + g] : 0.f;
    }
    FragB<BF16> fb;
    fb.set(bv);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_frag<BF16>(d[i][j], fa[i], fb);
  }
}

// d[i][j] = P^T W1 for the MT x 16 pixels m0 + 16 i + (0..15) and the
// units u0 + 8 j + (0..7): the paired map over depth blocks of 16 of the
// percept rows 0 .. P-1 (the last block's rows past P are zeros), W1 [P, ldw]
// in shared memory, ldw = 4 mod 32 for conflict-free reads (8 mod 32 costs a
// two-way conflict). Every (pixel, unit) gets the same bits whichever warp,
// MT or NT computes it.
template <bool BF16, int MT, int NT, typename A>
__device__ __forceinline__ void z1_mma(float d[MT][NT][4], A ps, const float* w1s, int ldw,
                                       int P, int m0, int u0, int g, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0.f;
  }
  const int kf = P & ~15;
#pragma unroll 1
  for (int k0 = 0; k0 < kf; k0 += 16)
    z1_block<BF16, MT, NT, false, A>(d, ps, w1s, ldw, P, m0, u0, k0, g, t);
  if (kf < P) z1_block<BF16, MT, NT, true, A>(d, ps, w1s, ldw, P, m0, u0, kf, g, t);
}

// d = z1 + b1 in place, without the certificate: the folded-stencil step
// (nca_step.cu's mat form), which no backward recomputes.
template <int MT, int NT>
__device__ __forceinline__ void z1_bias(float d[MT][NT][4], const float* b1s, int u0,
                                        int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] += b1s[u0 + 8 * j + 2 * t + (e & 1)];
    }
  }
}

// z1 of pixel m and unit u as the FMA chain over the percept rows in
// order: the plain version's bits, and the training forward's.
__device__ __noinline__ float z1_chain(Cols ps, const float* w1s, int ldw, int P, int m,
                                          int u) {
  float a = 0.f;
#pragma unroll 4
  for (int k = 0; k < P; ++k) a = fmaf(w1s[k * ldw + u], ps.at(k, m), a);
  return a;
}

// w1n[u] = sum_k |W1[k][u]| over the P rows, in row order (both kernels
// certify with the same bits), for u < FP. All threads of the block call
// it; the caller synchronises before z1_finish reads it.
__device__ __forceinline__ void z1_norms(float* w1n, const float* w1s, int ldw, int P, int FP,
                                         int tid, int nthr) {
  for (int u = tid; u < FP; u += nthr) {
    float s = 0.f;
    for (int k = 0; k < P; ++k) s += fabsf(w1s[k * ldw + u]);
    w1n[u] = s;
  }
}

// d = z1 + b1 in place, each element certified or recomputed as the chain
// (see the header): pmx[m] (and pmx2[m], the other half of a pixel's
// percept rows where two threads built it) is max_k |p_k| of pixel m.
template <int MT, int NT>
__device__ __forceinline__ void z1_finish(float d[MT][NT][4], Cols ps, const float* w1s, int ldw,
                                          const float* b1s, const float* w1n, const float* pmx,
                                          const float* pmx2, int P, int m0, int u0, int g,
                                          int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 16 * i + g + 8 * (e >> 1);
      const float pm = fmaxf(pmx[m], pmx2[m]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int u = u0 + 8 * j + 2 * t + (e & 1);
        float z = d[i][j][e] + b1s[u];
        if (fabsf(z) < Z1_KAPPA * pm * w1n[u]) z = z1_chain(ps, w1s, ldw, P, m, u) + b1s[u];
        d[i][j][e] = z;
      }
    }
  }
}
