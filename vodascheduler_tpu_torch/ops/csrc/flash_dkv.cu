// K3: flash-attention dK/dV for Hopper (sm_90a).
//
// Replaces `_dkv_kernel` in vodascheduler_tpu/ops/flash_attention.py (the
// second launch in `_bwd`): dK = Σᵢ dSᵀ·Q and dV = Σᵢ Pᵀ·dO, streaming the
// Q/dO tiles past each K tile, with Pᵀ = exp(K·Qᵀ·D^-½ − lse) and
// dSᵀ = Pᵀ∘(V·dOᵀ − δ)·D^-½.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): four products (K·Qᵀ,
// V·dOᵀ, Pᵀ·dO, dSᵀ·Q), halved under the causal mask: 137 GFLOP, 139 µs at
// B=8, H=16, S=2048, D=64, against ≈ 6·33.6 MB + 2·1 MB of bytes, 61 µs:
// compute-bound. The scores are computed transposed (keys on the rows), so
// Pᵀ and dSᵀ come out of one product as the A operand of the next and never
// leave registers; each Q/dO tile is read once per 64-row k tile, and the
// tiles above the diagonal are skipped.
//
// δ = rowsum(dO∘O) is read from `delta`, which the dQ kernel (flash_dq.cu)
// wrote earlier on the same stream, in place of a per-tile recompute from O.
//
// Grid: (ceil(Sk/64), H, B), one CTA per (b, h, 64-row k tile) looping over
// the Q/dO tiles; no atomics, so dK and dV are deterministic.

#include "flash_common.cuh"

namespace voda {

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int q_off,
                     int causal, float scale) {
  __shared__ __align__(16) bf16 qs[Smem<D>::TILE];
  __shared__ __align__(16) bf16 dos[Smem<D>::TILE];
  __shared__ float lse_s[BLOCK];
  __shared__ float delta_s[BLOCK];

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* db = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D;
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;
  const int k0 = j * BLOCK;

  // K and V go through the Q/dO buffers into registers once.
  load_tile<D>(qs, k + koff, k0, Sk, rs);
  load_tile<D>(dos, v + koff, k0, Sk, rs);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, qs, warp * 16, lane);
  load_a_frags<D>(va, dos, warp * 16, lane);
  __syncthreads();
  // key positions of this thread's two rows
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  const int num_q = (Sq + BLOCK - 1) / BLOCK;
  for (int i = 0; i < num_q; ++i) {
    if (!tile_runs(causal, q_off, i, j)) continue;
    load_tile<D>(qs, qb, i * BLOCK, Sq, rs);
    load_tile<D>(dos, db, i * BLOCK, Sq, rs);
    if (threadIdx.x < BLOCK) {
      const int r = i * BLOCK + threadIdx.x;
      lse_s[threadIdx.x] = r < Sq ? lse[stat + r] : 0.f;
      delta_s[threadIdx.x] = r < Sq ? delta[stat + r] : 0.f;
    }
    __syncthreads();

    float p[8][4], ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    }
    mma_abt<D>(p, ka, qs, lane);   // Sᵀ: keys x queries
    mma_abt<D>(ds, va, dos, lane); // (dO·Vᵀ)ᵀ
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query within the tile
        const int qcol = i * BLOCK + c;
        float x = p[n][e] * scale;
        if (qcol >= Sq || (causal && q_off + qcol < key[e >> 1])) x = NEG_INF;
        const float pe = __expf(x - lse_s[c]);
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - delta_s[c]) * scale;
      }
    }
    mma_pm<D>(dva, p, dos, lane);
    mma_pm<D>(dka, ds, qs, lane);
    __syncthreads();
  }

  const int r0 = k0 + warp * 16 + g;
  store_rows<D>(dk + koff, dka, r0, Sk, rs, 1.f, 1.f, lane);
  store_rows<D>(dv + koff, dva, r0, Sk, rs, 1.f, 1.f, lane);
}

}  // namespace voda

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head_dim without an instantiation.
extern "C" int voda_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int causal, float scale, void* stream) {
  using namespace voda;
  const dim3 grid((Sk + BLOCK - 1) / BLOCK, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VODA_DKV_ARGS                                                      \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),                \
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),         \
      static_cast<const float*>(lse), static_cast<const float*>(delta),    \
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, q_off,    \
      causal, scale
  if (D == 64)
    flash_dkv_kernel<64><<<grid, THREADS, 0, st>>>(VODA_DKV_ARGS);
  else if (D == 128)
    flash_dkv_kernel<128><<<grid, THREADS, 0, st>>>(VODA_DKV_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef VODA_DKV_ARGS
  return static_cast<int>(cudaGetLastError());
}
