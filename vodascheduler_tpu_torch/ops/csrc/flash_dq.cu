// K2: flash-attention dQ for Hopper (sm_90a).
//
// Replaces `_dq_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched in `_bwd`): dQ = Σⱼ dS·K with P = exp(S − lse) recomputed from
// Q·Kᵀ, dS = P∘(dO·Vᵀ − δ)·D^-½ and δ = rowsum(dO∘O).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): three products (QKᵀ,
// dO·Vᵀ, dS·K), halved under the causal mask: 103 GFLOP, 104 µs at B=8,
// H=16, S=2048, D=64, against ≈ 5·33.6 MB + 2·1 MB of bytes, 51 µs:
// compute-bound. As in the forward, P and dS live in registers only, each
// K/V tile is read once per 64-row q tile, and tiles above the diagonal are
// skipped.
//
// δ is computed here, once per row, from dO and O, and written to `delta`
// [B, H, Sq]: the dK/dV kernel (flash_dkv.cu), launched after this one on
// the same stream, reads it instead of recomputing it for every q tile.
//
// Grid: (ceil(Sq/64), H, B), one CTA per (b, h, 64-row q tile) looping over
// the K/V tiles; no atomics, so dQ is deterministic.

#include "flash_common.cuh"

namespace voda {

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, int q_off,
                    int causal, float scale) {
  __shared__ __align__(16) bf16 ks[Smem<D>::TILE];
  __shared__ __align__(16) bf16 vs[Smem<D>::TILE];
  __shared__ float delta_s[BLOCK];
  __shared__ float lse_s[BLOCK];

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;
  const int q0 = i * BLOCK;

  load_tile<D>(ks, q + qoff, q0, Sq, rs);
  load_tile<D>(vs, dout + qoff, q0, Sq, rs);
  __syncthreads();

  // δ for the warp's 16 rows: lanes stride D, a warp reduction per row.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int gr = q0 + r;
    float acc = 0.f;
    if (gr < Sq) {
      const bf16* orow = o + qoff + static_cast<size_t>(gr) * rs;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(vs[r * Smem<D>::STRIDE + d]) *
               __bfloat162float(orow[d]);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = gr < Sq ? lse[stat + gr] : 0.f;
      if (gr < Sq) delta[stat + gr] = acc;
    }
  }
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_frags<D>(qa, ks, warp * 16, lane);
  load_a_frags<D>(da, vs, warp * 16, lane);
  __syncthreads();
  const float lse_r[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
  const float del_r[2] = {delta_s[warp * 16 + g], delta_s[warp * 16 + g + 8]};
  const int row[2] = {q_off + q0 + warp * 16 + g, q_off + q0 + warp * 16 + g + 8};

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int num_k = (Sk + BLOCK - 1) / BLOCK;
  for (int j = 0; j < num_k && tile_runs(causal, q_off, i, j); ++j) {
    load_tile<D>(ks, kb, j * BLOCK, Sk, rs);
    load_tile<D>(vs, vb, j * BLOCK, Sk, rs);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_abt<D>(s, qa, ks, lane);
    mma_abt<D>(dp, da, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BLOCK + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (col >= Sk || (causal && row[e >> 1] < col)) x = NEG_INF;
        const float p = __expf(x - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - del_r[e >> 1]) * scale;  // dS
      }
    }
    mma_pm<D>(acc, s, ks, lane);
    __syncthreads();
  }

  store_rows<D>(dq + qoff, acc, q0 + warp * 16 + g, Sq, rs, 1.f, 1.f, lane);
}

}  // namespace voda

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head_dim without an instantiation.
extern "C" int voda_flash_dq(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, int B, int H, int Sq,
                             int Sk, int D, int q_off, int causal, float scale,
                             void* stream) {
  using namespace voda;
  const dim3 grid((Sq + BLOCK - 1) / BLOCK, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VODA_DQ_ARGS                                                        \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),                 \
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),             \
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),       \
      static_cast<float*>(delta), static_cast<bf16*>(dq), H, Sq, Sk, q_off, \
      causal, scale
  if (D == 64)
    flash_dq_kernel<64><<<grid, THREADS, 0, st>>>(VODA_DQ_ARGS);
  else if (D == 128)
    flash_dq_kernel<128><<<grid, THREADS, 0, st>>>(VODA_DQ_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef VODA_DQ_ARGS
  return static_cast<int>(cudaGetLastError());
}
