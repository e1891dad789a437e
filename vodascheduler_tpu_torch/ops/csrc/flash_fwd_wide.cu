// K1 for head widths above 128: the flash-attention forward for Hopper
// (sm_90a) at any D that is a multiple of 128.
//
// Replaces `_fwd_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_fwd`) where the JAX package takes D > 128 (a multiple of
// 128); flash_fwd.cu keeps D = 64 and 128. Streaming-softmax attention
// O = softmax(QKᵀ·scale)V with the causal mask offset by q_off, and
// lse = m + log l per row.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): two products of
// 2·B·H·Sq·Sk·D FLOPs, halved under the causal mask: at B=8, H=4, S=2048,
// D=256, 68.7 GFLOP, 69 µs, against 4·8·4·2048·256·2 B + lse ≈ 134 MB,
// 40 µs: compute-bound.
//
// Design (wide.cuh): a CTA owns 64 query rows of one (b, h) and one
// 128-wide chunk c of O (the grid's y axis). For each tile of 64 keys it
// sums S = Q·Kᵀ over every chunk of D, so the D/128 CTAs of a row block each
// compute the same S: the products do (D/128 + 1)/2 times the operations
// the bound counts (1.5 at D=256, 2.5 at D=512), the price of one softmax
// per row without atomics. The online
// softmax runs on S in shared memory (four threads a row), O's chunk stays
// in shared memory as fp32 and is rescaled by each tile's correction
// before O += P·V. Causal: key tiles past the block's last row are never
// loaded. Rows past Sq and keys past Sk are zero-filled; keys past Sk are
// masked.

#include "wide.cuh"

namespace voda {
namespace wide {

constexpr int FWD_SMEM = 2 * TILE_BYTES + SCORE_BYTES + PTILE_BYTES +
                         OUT_BYTES + 3 * BM * 4;

__global__ void __launch_bounds__(THREADS)
    flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Sk,
                          int D, int q_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem + TILE_BYTES);
  float* s = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(
      smem + 2 * TILE_BYTES + SCORE_BYTES);
  float* acc_o = reinterpret_cast<float*>(smem + 2 * TILE_BYTES +
                                          SCORE_BYTES + PTILE_BYTES);
  float* m_s = acc_o + BM * LDO;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int q0 = blockIdx.x * BM, c0 = blockIdx.y * CW, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const __nv_bfloat16* qh = q + ((long)b * Sq * H + h) * D;
  const __nv_bfloat16* kh = k + ((long)b * Sk * H + h) * D;
  const __nv_bfloat16* vh = v + ((long)b * Sk * H + h) * D;
  __nv_bfloat16* oh = o + ((long)b * Sq * H + h) * D;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = 16 * (warp % 4);  // the warp's rows
  const int ws = 32 * (warp / 4);  // its columns of a score tile
  const int wo = 64 * (warp / 4);  // its columns of the output chunk
  const int r = tid / 4, part = tid % 4;  // row-wise work: row, 16 columns
  const int row = q_off + q0 + r;         // the row's position among keys

  for (int i = tid; i < BM * LDO; i += THREADS) acc_o[i] = 0.0f;
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  const int kend = causal ? min(Sk, q_off + q0 + BM) : Sk;
  const int nc = D / CW;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    FragC sc[2];
    zero(sc);
    for (int j = 0; j < nc; ++j) {
      __syncthreads();  // the tiles' last readers are done
      load_tile(qt, qh, q0, Sq, rs, j * CW);
      load_tile(kt, kh, k0, Sk, rs, j * CW);
      __syncthreads();
      mma_abt(sc, qt, wr, kt, ws);
    }
    store_scores(s, sc, wr, ws);
    __syncthreads();
    load_tile(kt, vh, k0, Sk, rs, c0);  // V's chunk c, beside the softmax

    float x[16];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = k0 + part * 16 + i;
      const bool ok = col < Sk && (!causal || col <= row);
      x[i] = ok ? s[r * LDS + part * 16 + i] * scale : NEG_INF;
      mx = fmaxf(mx, x[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float e = x[i] == NEG_INF ? 0.0f : __expf(x[i] - m_new);
      sum += e;
      p[r * LDP + part * 16 + i] = __float2bfloat16(e);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    __syncwarp();  // every thread of the row has read m_old
    if (part == 0) {
      const float alpha = __expf(m_old - m_new);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
      a_s[r] = alpha;
    }
    __syncthreads();  // P, the corrections and V's chunk are in place

    for (int i = lane; i < 16 * 64; i += 32) {
      const int rr = wr + i / 64, cc = wo + i % 64;
      acc_o[rr * LDO + cc] *= a_s[rr];
    }
    __syncwarp();
    FragC oc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wmma::load_matrix_sync(oc[f], acc_o + wr * LDO + wo + 16 * f, LDO,
                             wmma::mem_row_major);
    mma_pv(oc, p, wr, kt, wo);
    store_out(acc_o, oc, wr, wo);
  }
  __syncthreads();
  if (tid < BM) {
    a_s[tid] = 1.0f / l_s[tid];
    if (blockIdx.y == 0 && q0 + tid < Sq)
      lse[(long)bh * Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
  }
  __syncthreads();
  write_chunk(oh, acc_o, a_s, q0, Sq, rs, c0);
}

}  // namespace wide
}  // namespace voda

extern "C" int voda_flash_fwd_wide(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int Sq, int Sk, int D, int q_off,
                                   int causal, float scale, void* stream) {
  using namespace voda::wide;
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_fwd_wide_kernel, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BM - 1) / BM, D / CW, B * H);
  flash_fwd_wide_kernel<<<grid, THREADS, FWD_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
