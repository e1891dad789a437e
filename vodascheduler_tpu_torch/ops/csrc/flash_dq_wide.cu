// K2 for head widths above 128: dQ of flash attention for Hopper (sm_90a)
// at any D that is a multiple of 128.
//
// Replaces `_dq_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_bwd`) where the JAX package takes D > 128; flash_dq.cu
// keeps D = 64 and 128. With P = exp(S·scale − lse) recomputed from the
// forward's lse and δ = rowsum(dO∘O): dS = P∘(dO·Vᵀ − δ)·scale and
// dQ = dS·K. It also writes δ for the dK/dV kernel, as flash_dq.cu does.
//
// Bound on an H100 SXM: three products of 2·B·H·Sq·Sk·D FLOPs (S, dP,
// dS·K), halved under the causal mask: at B=8, H=4, S=2048, D=256, 103
// GFLOP, 104 µs, against six [B,S,H,D] bf16 tensors and two row statistics
// ≈ 201 MB, 60 µs: compute-bound.
//
// Design (wide.cuh): a CTA owns 64 query rows of one (b, h) and one
// 128-wide chunk c of dQ. It computes δ of its rows over the whole of D
// (the CTA of chunk 0 writes it out), then, for each tile of 64 keys, S and
// dP summed over every chunk of D (both recomputed by each of the D/128
// CTAs of a row block: the products do (2·D/128 + 1)/3 times the operations
// the bound counts), dS in shared memory (four threads a row), and
// dQ += dS·K with K's chunk c, kept in registers as wmma accumulators.
// Causal: key tiles past the block's last row are never loaded.

#include "wide.cuh"

namespace voda {
namespace wide {

constexpr int DQ_SMEM = 4 * TILE_BYTES + 2 * SCORE_BYTES + PTILE_BYTES +
                        2 * BM * 4;

__global__ void __launch_bounds__(THREADS)
    flash_dq_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int Sq,
                         int Sk, int D, int q_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem + TILE_BYTES);
  __nv_bfloat16* dot =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * TILE_BYTES);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + 3 * TILE_BYTES);
  // S then dP, contiguous: at the end they hold dQ's chunk as fp32.
  float* s = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* dp = s + BM * LDS;
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(
      smem + 4 * TILE_BYTES + 2 * SCORE_BYTES);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TILE_BYTES +
                                          2 * SCORE_BYTES + PTILE_BYTES);
  float* dl_s = lse_s + BM;

  const int q0 = blockIdx.x * BM, c0 = blockIdx.y * CW, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long q_head = ((long)b * Sq * H + h) * D;
  const long k_head = ((long)b * Sk * H + h) * D;
  const __nv_bfloat16 *qh = q + q_head, *oh = o + q_head,
                      *doh = dout + q_head;
  const __nv_bfloat16 *kh = k + k_head, *vh = v + k_head;

  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = 16 * (warp % 4), ws = 32 * (warp / 4), wo = 64 * (warp / 4);
  const int r = tid / 4, part = tid % 4;
  const int row = q_off + q0 + r;

  // δ of row r over the whole of D: four threads a row, D/4 columns each.
  float dl = 0.0f;
  if (q0 + r < Sq) {
    const __nv_bfloat16* orow = oh + (long)(q0 + r) * rs;
    const __nv_bfloat16* drow = doh + (long)(q0 + r) * rs;
    for (int c = part * (D / 4); c < (part + 1) * (D / 4); c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = __bfloat1622float2(o2[i]);
        const float2 df = __bfloat1622float2(d2[i]);
        dl += of.x * df.x + of.y * df.y;
      }
    }
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (part == 0) {
    dl_s[r] = dl;
    lse_s[r] = q0 + r < Sq ? lse[(long)bh * Sq + q0 + r] : 0.0f;
    if (blockIdx.y == 0 && q0 + r < Sq) delta[(long)bh * Sq + q0 + r] = dl;
  }

  FragC dqc[4];
  zero(dqc);
  const int kend = causal ? min(Sk, q_off + q0 + BM) : Sk;
  const int nc = D / CW;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    FragC sc[2], pc[2];
    zero(sc);
    zero(pc);
    for (int j = 0; j < nc; ++j) {
      __syncthreads();  // the tiles' last readers are done
      load_tile(qt, qh, q0, Sq, rs, j * CW);
      load_tile(kt, kh, k0, Sk, rs, j * CW);
      load_tile(dot, doh, q0, Sq, rs, j * CW);
      load_tile(vt, vh, k0, Sk, rs, j * CW);
      __syncthreads();
      mma_abt(sc, qt, wr, kt, ws);
      mma_abt(pc, dot, wr, vt, ws);
    }
    store_scores(s, sc, wr, ws);
    store_scores(dp, pc, wr, ws);
    __syncthreads();
    load_tile(kt, kh, k0, Sk, rs, c0);  // K's chunk c, beside dS

#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cc = part * 16 + i, col = k0 + cc;
      const bool ok = col < Sk && (!causal || col <= row);
      const float pv = ok ? __expf(s[r * LDS + cc] * scale - lse_s[r]) : 0.0f;
      ds[r * LDP + cc] =
          __float2bfloat16(pv * (dp[r * LDS + cc] - dl_s[r]) * scale);
    }
    __syncthreads();  // dS and K's chunk are in place
    mma_pv(dqc, ds, wr, kt, wo);
  }
  __syncthreads();
  store_out(s, dqc, wr, wo);
  __syncthreads();
  write_chunk(dq + q_head, s, nullptr, q0, Sq, rs, c0);
}

}  // namespace wide
}  // namespace voda

extern "C" int voda_flash_dq_wide(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int B, int H, int Sq, int Sk, int D,
                                  int q_off, int causal, float scale,
                                  void* stream) {
  using namespace voda::wide;
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_dq_wide_kernel, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BM - 1) / BM, D / CW, B * H);
  flash_dq_wide_kernel<<<grid, THREADS, DQ_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
