// Shared parts of the wmma flash-attention kernels for head widths above
// 512: bf16's dQ and dK/dV (flash_dq_wide.cu, flash_dkv_wide.cu), and the
// forward of flash_fwd_wide.cu, which no wrapper routes to any more (its
// entry, voda_flash_fwd_wmma, is timed against flash_fwd_chunked_kernel,
// the TMA + wgmma forward that streams D and took its route). fp16's dQ and
// dK/dV above 512 are those files' TMA + wgmma kernels that stream D
// (flash_dq_chunked_kernel, flash_dkv_chunked_kernel); these wmma kernels
// are bf16 code. Widths 256, 384 and 512 run those files' TMA + wgmma
// kernels on hopper.cuh, which hold a CTA's operands resident in shared
// memory beside a ring of tiles; above 512 they no longer fit.
//
// These kernels cut D instead: each CTA owns one 128-wide chunk of its
// output's width (O, dQ, dK or dV) and recomputes the scores S = Q·Kᵀ (and
// dP = dO·Vᵀ) it needs by summing over every 128-wide chunk of D. So there is one softmax per row, nothing is reduced across
// CTAs (no atomics, deterministic), and any multiple of 128 runs with the
// same shared memory.
//
// Products are warp-level tensor-core ops (nvcuda::wmma, bf16 in, fp32
// sums, 16×16×16 tiles). An accumulator fragment's layout is opaque, so the
// row-wise work (the online softmax, P and dS) runs on fp32 tiles that the
// warps store to shared memory. Tiles come from global memory by plain
// 16-byte loads of all threads, between barriers: simple first, no overlap
// of loads and products (PERF.md has the times).
//
// A CTA has 8 warps (256 threads) and owns 64 rows (queries, or keys in the
// dK/dV kernel) against tiles of 64 of the other axis. Warp w works on rows
// 16·(w%4)… and, for a 64×64 score tile, on columns 32·(w/4)…, for a
// 64×128 output chunk on columns 64·(w/4)….

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace voda {
namespace wide {

using namespace nvcuda;

constexpr int BM = 64;        // rows a CTA owns
constexpr int BN = 64;        // rows of the other axis per tile
constexpr int CW = 128;       // width of one chunk of D
constexpr int THREADS = 256;  // 8 warps
constexpr int LDT = CW + 8;   // bf16 tile row, padded against bank conflicts
constexpr int LDS = BN + 4;   // fp32 score tile row
constexpr int LDP = BN + 8;   // bf16 P / dS tile row
constexpr int LDO = CW + 4;   // fp32 output-chunk row
constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernels

constexpr int TILE_BYTES = BM * LDT * 2;    // 17408
constexpr int SCORE_BYTES = BM * LDS * 4;   // 17408
constexpr int PTILE_BYTES = BM * LDP * 2;   // 9216
constexpr int OUT_BYTES = BM * LDO * 4;     // 33792

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [r0, r0 + 64) of one head's [S, D] slice (row stride `rs` elements),
// columns [c0, c0 + 128), into a [64][LDT] bf16 tile; rows past `rows` are
// zeros. 1024 16-byte vectors, four a thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* head, int r0,
                                          int rows, long rs, int c0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < (BM * CW / 8) / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int r = idx / (CW / 8), vec = idx % (CW / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(head + (long)(r0 + r) * rs + c0 +
                                            vec * 8);
    *reinterpret_cast<uint4*>(tile + r * LDT + vec * 8) = val;
  }
}

// acc[f] += A[16 rows at a_row][CW] · B, where B is the transpose of the
// 16-row slices of `bt` at bt_row + 16·f (a product with a K-major operand:
// S = Q·Kᵀ, dP = dO·Vᵀ, Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ).
template <int NF>
__device__ __forceinline__ void mma_abt(FragC (&acc)[NF],
                                        const __nv_bfloat16* a, int a_row,
                                        const __nv_bfloat16* bt, int bt_row) {
#pragma unroll
  for (int kk = 0; kk < CW / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + a_row * LDT + kk * 16, LDT);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      FragBt fb;
      wmma::load_matrix_sync(fb, bt + (bt_row + 16 * f) * LDT + kk * 16, LDT);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// acc[f] += P[16 rows at p_row][BN] · V[BN][16 columns at col + 16·f]:
// the products with an MN-major operand (O += P·V, dQ += dS·K,
// dV += Pᵀ·dO, dK += dSᵀ·Q).
template <int NF>
__device__ __forceinline__ void mma_pv(FragC (&acc)[NF],
                                       const __nv_bfloat16* p, int p_row,
                                       const __nv_bfloat16* v, int col) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + p_row * LDP + kk * 16, LDP);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      FragB fb;
      wmma::load_matrix_sync(fb, v + kk * 16 * LDT + col + 16 * f, LDT);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
}

// A score tile's two fragments to the fp32 [64][LDS] tile.
__device__ __forceinline__ void store_scores(float* s, FragC (&acc)[2],
                                             int row, int col) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(s + row * LDS + col + 16 * f, acc[f], LDS,
                            wmma::mem_row_major);
}

// Four output fragments (16 rows × 64 columns) to an fp32 [64][LDO] tile.
__device__ __forceinline__ void store_out(float* o, FragC (&acc)[4], int row,
                                          int col) {
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(o + row * LDO + col + 16 * f, acc[f], LDO,
                            wmma::mem_row_major);
}

// The fp32 [64][LDO] chunk, times `row_scale` per row where it is given, as
// bf16 into rows [r0, r0 + 64) (those below `rows`) of one head's slice,
// columns [c0, c0 + 128).
__device__ __forceinline__ void write_chunk(__nv_bfloat16* head,
                                            const float* o,
                                            const float* row_scale, int r0,
                                            int rows, long rs, int c0) {
  for (int idx = threadIdx.x; idx < BM * CW / 2; idx += THREADS) {
    const int r = idx / (CW / 2), c = 2 * (idx % (CW / 2));
    if (r0 + r >= rows) continue;
    const float sc = row_scale ? row_scale[r] : 1.0f;
    __nv_bfloat162 val = __floats2bfloat162_rn(o[r * LDO + c] * sc,
                                               o[r * LDO + c + 1] * sc);
    *reinterpret_cast<__nv_bfloat162*>(head + (long)(r0 + r) * rs + c0 + c) =
        val;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// on request).
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// What every entry point checks before a launch.
__host__ inline bool shape_ok(int B, int H, int Sq, int Sk, int D) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && D > 0 && D % CW == 0 &&
         (long)B * H <= 65535 && D / CW <= 65535;
}

}  // namespace wide
}  // namespace voda
