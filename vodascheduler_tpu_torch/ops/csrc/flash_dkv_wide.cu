// K3 for head widths above 128: dK and dV of flash attention for Hopper
// (sm_90a) at any D that is a multiple of 128.
//
// Replaces `_dkv_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_bwd`) where the JAX package takes D > 128; flash_dkv.cu
// keeps D = 64 and 128. With P = exp(S·scale − lse) and dS = P∘(dO·Vᵀ −
// δ)·scale recomputed from the forward's lse and the dQ kernel's δ:
// dK = dSᵀ·Q and dV = Pᵀ·dO.
//
// Bound on an H100 SXM: four products of 2·B·H·Sq·Sk·D FLOPs (S, dP,
// Pᵀ·dO, dSᵀ·Q), halved under the causal mask: at B=8, H=4, S=2048,
// D=256, 137 GFLOP, 139 µs, against six [B,S,H,D] bf16 tensors and two row
// statistics ≈ 201 MB, 60 µs: compute-bound.
//
// Design (wide.cuh): a CTA owns 64 keys of one (b, h) and one 128-wide
// chunk c of dK and dV. For each tile of 64 queries it computes Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ summed over every chunk of D (recomputed by each of the
// D/128 CTAs of a key block: the products do (D/128 + 1)/2 times the
// operations the bound counts), then Pᵀ and dSᵀ in shared memory (four
// threads a key), then dV += Pᵀ·dO and dK += dSᵀ·Q with Q's and dO's chunk
// c, both kept in registers as wmma accumulators. Causal: query tiles
// wholly before the block's first key are never loaded; a key block no
// query sees writes zeros.

#include "wide.cuh"

namespace voda {
namespace wide {

constexpr int DKV_SMEM = 4 * TILE_BYTES + 2 * SCORE_BYTES + 2 * PTILE_BYTES +
                         2 * BN * 4;
static_assert(2 * OUT_BYTES <= 4 * TILE_BYTES,
              "dK's and dV's chunks are staged in the tiles' space");

__global__ void __launch_bounds__(THREADS)
    flash_dkv_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int Sq,
                          int Sk, int D, int q_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem + TILE_BYTES);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + 2 * TILE_BYTES);
  __nv_bfloat16* dot =
      reinterpret_cast<__nv_bfloat16*>(smem + 3 * TILE_BYTES);
  float* st = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* dpt = st + BM * LDS;
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(
      smem + 4 * TILE_BYTES + 2 * SCORE_BYTES);
  __nv_bfloat16* dst = pt + BM * LDP;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TILE_BYTES +
                                          2 * SCORE_BYTES + 2 * PTILE_BYTES);
  float* dl_s = lse_s + BN;

  const int k0 = blockIdx.x * BM, c0 = blockIdx.y * CW, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long q_head = ((long)b * Sq * H + h) * D;
  const long k_head = ((long)b * Sk * H + h) * D;
  const __nv_bfloat16 *qh = q + q_head, *doh = dout + q_head;
  const __nv_bfloat16 *kh = k + k_head, *vh = v + k_head;

  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = 16 * (warp % 4), ws = 32 * (warp / 4), wo = 64 * (warp / 4);
  const int r = tid / 4, part = tid % 4;  // row-wise work: key, 16 queries
  const int key = k0 + r;

  FragC dkc[4], dvc[4];
  zero(dkc);
  zero(dvc);
  int qstart = causal ? max(0, k0 - q_off) : 0;
  qstart -= qstart % BN;
  const int nc = D / CW;
  for (int q0 = qstart; q0 < Sq; q0 += BN) {
    // The last readers of the statistics finished before the barrier
    // ahead of the previous tile's products.
    if (tid < BN) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[(long)bh * Sq + q0 + tid] : 0.0f;
      dl_s[tid] = in ? delta[(long)bh * Sq + q0 + tid] : 0.0f;
    }
    FragC sc[2], pc[2];
    zero(sc);
    zero(pc);
    for (int j = 0; j < nc; ++j) {
      __syncthreads();  // the tiles' last readers are done
      load_tile(kt, kh, k0, Sk, rs, j * CW);
      load_tile(qt, qh, q0, Sq, rs, j * CW);
      load_tile(vt, vh, k0, Sk, rs, j * CW);
      load_tile(dot, doh, q0, Sq, rs, j * CW);
      __syncthreads();
      mma_abt(sc, kt, wr, qt, ws);
      mma_abt(pc, vt, wr, dot, ws);
    }
    store_scores(st, sc, wr, ws);
    store_scores(dpt, pc, wr, ws);
    __syncthreads();
    load_tile(qt, qh, q0, Sq, rs, c0);  // Q's and dO's chunk c, beside Pᵀ
    load_tile(dot, doh, q0, Sq, rs, c0);

#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cc = part * 16 + i, qq = q0 + cc;
      const bool ok = qq < Sq && key < Sk && (!causal || key <= q_off + qq);
      const float pv =
          ok ? __expf(st[r * LDS + cc] * scale - lse_s[cc]) : 0.0f;
      pt[r * LDP + cc] = __float2bfloat16(pv);
      dst[r * LDP + cc] =
          __float2bfloat16(pv * (dpt[r * LDS + cc] - dl_s[cc]) * scale);
    }
    __syncthreads();  // Pᵀ, dSᵀ and the chunks are in place
    mma_pv(dvc, pt, wr, dot, wo);
    mma_pv(dkc, dst, wr, qt, wo);
  }
  __syncthreads();
  float* dk_out = reinterpret_cast<float*>(smem);
  float* dv_out = reinterpret_cast<float*>(smem + OUT_BYTES);
  store_out(dk_out, dkc, wr, wo);
  store_out(dv_out, dvc, wr, wo);
  __syncthreads();
  write_chunk(dk + k_head, dk_out, nullptr, k0, Sk, rs, c0);
  write_chunk(dv + k_head, dv_out, nullptr, k0, Sk, rs, c0);
}

}  // namespace wide
}  // namespace voda

extern "C" int voda_flash_dkv_wide(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int causal,
                                   float scale, void* stream) {
  using namespace voda::wide;
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_dkv_wide_kernel, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sk + BM - 1) / BM, D / CW, B * H);
  flash_dkv_wide_kernel<<<grid, THREADS, DKV_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq,
      Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
