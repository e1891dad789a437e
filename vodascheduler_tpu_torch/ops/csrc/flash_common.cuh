// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu).
//
// Layout: q, k, v, o, do, dq, dk, dv are bf16 [B, S, H, D] contiguous (the
// model layout, so no transpose runs around the kernels); lse and delta are
// fp32 [B, H, S]. Each CTA is 4 warps over one 64-row tile; each warp owns
// 16 rows and multiplies with mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4*g + t):
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16x8  (k x n):   b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C 16x8  fp32:      c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// A C tile of two neighbouring n-tiles is, after a cast to bf16, exactly the
// A fragment of the next product (P·V, dS·K, ...), so P and dS never leave
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace voda {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernels
constexpr int BLOCK = 64;          // rows of a q tile and of a k tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Shared-memory row stride in elements: 8 bf16 of padding keep 16-byte
// row alignment and put the 8 rows a fragment load touches on distinct
// banks.
template <int D>
struct Smem {
  static constexpr int STRIDE = D + 8;
  static constexpr int TILE = BLOCK * STRIDE;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t ld16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Rows [row0, row0 + BLOCK) of one (b, h) slice into shared memory, 16 bytes
// a thread per load; rows at or past `nrows` are zero (the ragged edge).
// `base` points at element (b, 0, h, 0); row r starts at base + r*row_stride.
template <int D>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* base,
                                          int row0, int nrows,
                                          int row_stride) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < BLOCK * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(smem + r * Smem<D>::STRIDE + c) = val;
  }
}

// A fragments of the 16 x D block at shared rows [r0, r0+16), all D/16
// k-steps: the operand a warp keeps in registers for the whole loop.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const bf16* smem, int r0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = smem + (r0 + g) * Smem<D>::STRIDE + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * Smem<D>::STRIDE;
    a[kk][0] = ld32(p0);
    a[kk][1] = ld32(p1);
    a[kk][2] = ld32(p0 + 8);
    a[kk][3] = ld32(p1 + 8);
  }
}

// acc[16 x 64] += A[16 x D] · M[64 x D]ᵀ, M a shared tile whose rows are the
// product's columns (QKᵀ, dO·Vᵀ, K·Qᵀ, V·dOᵀ): B fragments are 32-bit loads
// along a row.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* m, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* p = m + (n * 8 + g) * Smem<D>::STRIDE + kk * 16 + 2 * t;
      mma_bf16(acc[n], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// acc[16 x D] += P[16 x 64] · M[64 x D], P given as the fp32 C tiles of a
// previous product (cast to bf16 here, as the reference casts P and dS
// before their products), M a shared tile read down its columns.
template <int D>
__device__ __forceinline__ void mma_pm(float (&acc)[D / 8][4],
                                       const float (&p)[8][4], const bf16* m,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* r0 = m + (kk * 16 + 2 * t) * Smem<D>::STRIDE;
    const bf16* r1 = r0 + Smem<D>::STRIDE;
    const bf16* r8 = r0 + 8 * Smem<D>::STRIDE;
    const bf16* r9 = r8 + Smem<D>::STRIDE;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + g;
      mma_bf16(acc[dn], pa, pack_raw(ld16(r0 + c), ld16(r1 + c)),
               pack_raw(ld16(r8 + c), ld16(r9 + c)));
    }
  }
}

// Stores the 16 x D fp32 accumulator of a warp as bf16 rows of a
// [B, S, H, D] tensor, times a per-row factor; rows at or past `nrows` are
// dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[D / 8][4],
                                           int row, int nrows, int row_stride,
                                           float f0, float f1, int lane) {
  const int t = lane & 3;
  if (row < nrows) {
    bf16* p = base + static_cast<size_t>(row) * row_stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(p + dn * 8) =
          pack_bf16(acc[dn][0] * f0, acc[dn][1] * f0);
  }
  if (row + 8 < nrows) {
    bf16* p = base + static_cast<size_t>(row + 8) * row_stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(p + dn * 8) =
          pack_bf16(acc[dn][2] * f1, acc[dn][3] * f1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The causal tile predicate of the reference: q tile i meets k tile j when
// its last row sees the tile's first key.
__device__ __forceinline__ bool tile_runs(int causal, int q_off, int i, int j) {
  return !causal || q_off + (i + 1) * BLOCK - 1 >= j * BLOCK;
}

}  // namespace voda
