// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_fwd`): streaming-softmax attention O = softmax(QKᵀ·D^-½)V
// with the causal mask offset by q_off, emitting lse = m + log l per row.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): two products of
// 2·B·H·Sq·Sk·D FLOPs, halved under the causal mask. At B=8, H=16, S=2048,
// D=64 that is 68.7 GFLOP, 69 µs, against 4·8·16·2048·64·2 B + lse ≈ 135 MB,
// 40 µs: compute-bound. The design keeps the S x S scores out of device
// memory (they live in the registers of one warp, 16 rows at a time), reads
// each K/V tile once per 64-row q tile, and skips the tiles above the
// diagonal, so the work is the causal half. It is the simple form:
// mma.sync from padded shared tiles, no TMA, no wgmma, no pipelining
// between the tile load and the products.
//
// Grid: (ceil(Sq/64), H, B), one CTA per (b, h, 64-row q tile) looping over
// the K/V tiles; nothing is carried between CTAs, so the result is
// deterministic.

#include "flash_common.cuh"

namespace voda {

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, int q_off,
                     int causal, float scale) {
  __shared__ __align__(16) bf16 ks[Smem<D>::TILE];
  __shared__ __align__(16) bf16 vs[Smem<D>::TILE];

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rs = H * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const int q0 = i * BLOCK;

  // Q goes through the K buffer into registers once.
  load_tile<D>(ks, qb, q0, Sq, rs);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, ks, warp * 16, lane);
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  // global positions of this thread's two rows (g and g+8 of the warp)
  const int row[2] = {q_off + q0 + warp * 16 + g, q_off + q0 + warp * 16 + g + 8};

  const int num_k = (Sk + BLOCK - 1) / BLOCK;
  for (int j = 0; j < num_k && tile_runs(causal, q_off, i, j); ++j) {
    load_tile<D>(ks, kb, j * BLOCK, Sk, rs);
    load_tile<D>(vs, vb, j * BLOCK, Sk, rs);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<D>(s, qa, ks, lane);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BLOCK + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (col >= Sk || (causal && row[e >> 1] < col)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rsum[r]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    mma_pm<D>(acc, s, vs, lane);
    __syncthreads();
  }

  // Flush: a row that saw no key (l == 0) gets output 0, as the reference.
  const float linv0 = l[0] == 0.f ? 1.f : 1.f / l[0];
  const float linv1 = l[1] == 0.f ? 1.f : 1.f / l[1];
  const int r0 = q0 + warp * 16 + g;
  store_rows<D>(o + (static_cast<size_t>(b) * Sq * H + h) * D, acc, r0, Sq,
                rs, linv0, linv1, lane);
  if (t == 0) {
    float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
    if (r0 < Sq) lb[r0] = m[0] + logf(l[0] == 0.f ? 1.f : l[0]);
    if (r0 + 8 < Sq) lb[r0 + 8] = m[1] + logf(l[1] == 0.f ? 1.f : l[1]);
  }
}

}  // namespace voda

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head_dim without an instantiation.
extern "C" int voda_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Sq, int Sk,
                              int D, int q_off, int causal, float scale,
                              void* stream) {
  using namespace voda;
  const dim3 grid((Sq + BLOCK - 1) / BLOCK, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (D == 64)
    flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, lp, H, Sq,
                                                   Sk, q_off, causal, scale);
  else if (D == 128)
    flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, lp, H, Sq,
                                                    Sk, q_off, causal, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
