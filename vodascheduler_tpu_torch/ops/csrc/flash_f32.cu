// K1, K2 and K3 for fp32 inputs on Hopper's tensor cores (sm_90a): the
// forward at head widths 64 and 128 (voda_flash_fwd_f32) and at every
// multiple of 128 above (the same function streaming D:
// voda_flash_fwd_f32_wide, below the D ≤ 128 kernel); dQ and dK/dV at every
// width, one kernel each that streams D (voda_flash_dq_f32 and
// voda_flash_dkv_f32 up to 128, voda_flash_dq_f32_wide and
// voda_flash_dkv_f32_wide above; at the end of the file).
//
// Replace `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` in
// vodascheduler_tpu/ops/flash_attention.py for a model that computes in
// float32 (the TPU kernels compute in q.dtype), at every width the JAX
// package takes. The CUDA-core kernels these replaced keep their entries in
// flash_simt.cu only to be timed (voda_flash_{fwd,dq,dkv}_f32_simt).
//
// The arithmetic: three TF32 passes. Every product a·b of fp32 inputs
// becomes three tensor-core products of TF32 halves summed in one fp32
// accumulator: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi) (x − hi is
// exact in fp32), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the small
// terms first, as CUTLASS's OpMultiplyAddFastF32 orders them (and as the
// library's own fp32 attention on this card computes). Only a_lo·b_lo, near
// 2^-22 of the product, is dropped, so the result is as accurate as an fp32
// product on the CUDA cores; one pass (hi·hi alone) keeps 11 bits and reads
// about 1000× further from the plain version (tests/torch_f32x3_model.py).
// P, dSᵀ and dS stay fp32 and are split like any operand (`p.astype(v.dtype)`
// and `ds.astype(k.dtype)` are no-ops for fp32); the softmax statistics, lse
// and δ are fp32 as on the CUDA cores.
//
// A fifth divergence from the TPU kernels, beside lse's layout, any sequence
// length, the zero-padded head widths and the fixed tiles (the module
// docstring of ops/flash_attention.py): the TPU emulates an f32 dot in
// several bf16 passes on its matrix unit ("the multi-pass f32 MXU path",
// `_fwd_kernel`); here it is three TF32 passes, at least as accurate.
//
// Bound on an H100 SXM: the card's fp32-accurate rate is TF32's 495 TFLOP/s
// over three passes, 165 TFLOP/s. K1 does two products of 2·B·H·Sq·Sk·D
// FLOPs, halved under the causal mask: 68.7 GFLOP at B=8, H=16, S=2048,
// D=64, 0.417 ms, against 4·33.6 MB + lse ≈ 135 MB, 0.040 ms; K2 three,
// 0.625 ms; K3 four, 0.833 ms against 0.061 ms. All are bound by
// operations, and so are they at the same B·H·D in heads of 256 (B=8, H=4),
// where each of the D/128 CTAs of a row or key block computes the same S
// (Sᵀ and dPᵀ in K3), so that K1 and K3 do (D/128 + 1)/2 times the bound's
// operations.
//
// K1 (flash_fwd_f32_kernel): the TMA + warp-specialised wgmma design of
// flash_fwd.cu (one producer warp of TMA loads into a ring, two consumer
// warpgroups of 64 query rows, the online softmax on the accumulator
// registers, the warpgroups' turns) in TF32. What TF32 changes:
// - wgmma's .tf32 form reads both operands K-major (there is no transpose
//   bit) and a k-step of 8 values, 32 bytes, as bf16's k16. S = Q·Kᵀ is
//   K-major in both operands. O += P·V is not: V arrives as Vᵀ, keys
//   contiguous. A prologue kernel (flash_f32_split_kernel), launched by the
//   same C entry, writes K_hi, K_lo, Vᵀ_hi and Vᵀ_lo into scratch that the
//   wrapper allocates, so the main loop stays a pure TMA + wgmma pipeline.
//   It reads K and V and writes twice their bytes, 0.4 GB at the main
//   shape, some 0.12 ms at 3.35 TB/s.
// - P is the register A operand of P·V. TF32's A fragment of a k-step holds
//   columns t and t+4 of the thread's rows, the accumulator columns 2t and
//   2t+1. The prologue stores Vᵀ's keys in the order PERM = [0,2,4,6,1,3,5,7]
//   within each group of 8, so the thread's accumulator pair is its A
//   fragment as it stands: P never leaves registers.
// - Q arrives once by TMA, raw; each consumer warpgroup splits its 64 rows
//   in shared memory (hi in place, lo beside it) and reads both as wgmma A
//   operands from shared memory.
// - fp32 tiles are twice bf16's and the split doubles every tile: at D=64,
//   K/V tiles of 64 keys (a stage of K_hi, K_lo, Vᵀ_hi, Vᵀ_lo is 64 KB), two
//   stages and Q's 64 KB, 193 KB of the 227; at D=128, tiles of 32 keys and
//   one stage (Q alone is 128 KB). K and V have stages and barriers of
//   their own: K of tile j is released once S of tile j is in, V once P·V
//   is, so even one stage overlaps S of tile j with P·V of tile j−1.
// - Rows past Sq arrive from TMA as zeros and are never stored; keys past
//   Sk arrive as zeros and are masked to the finite NEG_INF.
//
// K2 and K3 (flash_dq_f32_kernel, flash_dkv_f32_kernel) have their own
// headers below: the same TMA + wgmma design, with the operands that stay
// in shared memory split into TF32 halves by a prologue (K2 still splits Q
// and dO in the CTA; K3 splits nothing there but Pᵀ and dSᵀ), and S (K2)
// or Sᵀ and dPᵀ (K3) summed over 32-column chunks of D, each chunk apart.
//
// Nothing is carried between CTAs and no kernel uses atomics, so all of
// them are deterministic.

#include "hopper.cuh"

namespace voda {
namespace f32 {

// ------------------------------------------------------------ the split

// x rounded to TF32 (10 stored mantissa bits; to nearest, ties away from
// zero), in an fp32 register whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t hi, lo;
};

// x = hi + lo + (what TF32 cannot hold of x − hi, below 2^-21 of x).
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  const uint32_t lo = to_tf32(x - __uint_as_float(hi));
  return {hi, lo};
}

// Key order of Vᵀ (K1) and Kᵀ (K2) within each group of 8, and of the query
// axis of Qᵀ and dOᵀ (K3): logical column j of a k-step holds physical
// column PERM(j).
__host__ __device__ constexpr int perm8(int j) {
  return j < 4 ? 2 * j : 2 * (j - 4) + 1;
}

// ---------------------------------------------------------------- tiles

// An fp32 tile of a tensor map below lands as parts of 32 columns, each
// [rows, 32] with 128-byte rows in the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)); part p starts at p * rows * 128 bytes. As in
// hopper.cuh for 16-bit tiles, one k-step of wgmma is 32 bytes of a row, so
// kmajor_step(rows, kk) addresses k-step kk (8 values) of such a tile.

// A tensor map over a contiguous fp32 tensor of dims (innermost first)
// `dims`, boxes of `box`, 128-byte swizzle, zeros out of bounds. Returns 0 or
// a nonzero CUresult.
inline int make_map(CUtensorMap* map, const void* base, const int (&dims)[4],
                    const int (&box)[4]) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[4], strides[3];
  cuuint32_t bdim[4];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  cuuint64_t stride = 4;
  for (int i = 0; i < 4; ++i) {
    if (i > 0) strides[i - 1] = stride;
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    stride *= static_cast<cuuint64_t>(dims[i]);
  }
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), gdim,
      strides, bdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// fp32 [B, S, H, D] in boxes of [rows, 32]: coordinates (column, h, s, b).
inline int rows_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, int rows) {
  return make_map(map, base, {D, H, S, B}, {32, 1, rows, 1});
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [s0, s0 + rows) of head h, batch b, all D columns, of a rows_map.
template <int D>
__device__ __forceinline__ void tma_rows(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h,
                                         int s0, int b) {
#pragma unroll
  for (int p = 0; p < D / 32; ++p)
    tma_load(dst + p * rows * 32, map, bar, 32 * p, h, s0, b);
}

// --------------------------------------------------------- wgmma, TF32

#define VODA_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VODA_F16(i) VODA_F4(i), VODA_F4(i + 4), VODA_F4(i + 8), VODA_F4(i + 12)
#define VODA_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define VODA_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define VODA_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x N] (+)= A · B in TF32, A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float (&d)[16], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " VODA_R16
      ", %16, %17, p, 1, 1;\n}"
      : VODA_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<64>(float (&d)[32], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VODA_R32
      ", %32, %33, p, 1, 1;\n}"
      : VODA_F16(0), VODA_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A · B in TF32, A a register fragment, B K-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VODA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : VODA_F16(0), VODA_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VODA_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : VODA_F16(0), VODA_F16(16), VODA_F16(32), VODA_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef VODA_F4
#undef VODA_F16
#undef VODA_R16
#undef VODA_R32
#undef VODA_R64

// The A fragment {x0, x1, x2, x3} split into its hi and lo fragments.
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           float x0, float x1, float x2,
                                           float x3) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split s = split(x[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

// ---------------------------------------------------------------------------
// K1's prologue: K_hi, K_lo as [B, Sk, H, D] (K's layout) and Vᵀ_hi, Vᵀ_lo as
// [B, H, D, SkP] (SkP = Sk rounded up to 8: keys contiguous in the order
// PERM within each group of 8, zeros past Sk)
// ---------------------------------------------------------------------------

constexpr int PT = 32;  // keys and columns of a prologue tile

__global__ void __launch_bounds__(256)
    flash_f32_split_kernel(const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ kh,
                           float* __restrict__ kl, float* __restrict__ vth,
                           float* __restrict__ vtl, int H, int Sk, int SkP,
                           int D) {
  __shared__ float tile[PT][PT + 1];  // V[key0 + r][d0 + c]
  const int key0 = blockIdx.x * PT, d0 = blockIdx.y * PT;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const int key = key0 + r;
    float x = 0.f;
    if (key < Sk) {
      const size_t i =
          ((static_cast<size_t>(b) * Sk + key) * H + h) * D + d0 + tx;
      const Split s = split(k[i]);
      kh[i] = __uint_as_float(s.hi);
      kl[i] = __uint_as_float(s.lo);
      x = v[i];
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  const int pos = key0 + tx;
  if (pos >= SkP) return;
  const int src = (tx & ~7) + perm8(tx & 7);
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const Split s = split(tile[src][r]);
    const size_t i =
        ((static_cast<size_t>(b) * H + h) * D + d0 + r) * SkP + pos;
    vth[i] = __uint_as_float(s.hi);
    vtl[i] = __uint_as_float(s.lo);
  }
}

// ---------------------------------------------------------------------------
// K1: O and lse
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int BM = 128;  // query rows of a CTA
  // keys of a K/V tile and stages: a stage holds K_hi, K_lo, Vᵀ_hi and
  // Vᵀ_lo, and Q_hi and Q_lo stay for the CTA's life
  static constexpr int BN = D == 64 ? 64 : 32;
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int Q_BYTES = BM * D * 4;   // each of Q_hi, Q_lo
  static constexpr int KV_BYTES = BN * D * 4;  // each of the stage's four
  static constexpr int QL_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;    // [STAGES][K_hi, K_lo]
  static constexpr int V_OFF = K_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * 2 * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES],
  // v_empty[STAGES]; 1 KB of slack to align the base to the swizzle's 1024
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES);
  static_assert(SMEM <= MAX_SMEM, "K1's tiles exceed shared memory");
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tkh,
                         const __grid_constant__ CUtensorMap tkl,
                         const __grid_constant__ CUtensorMap tvh,
                         const __grid_constant__ CUtensorMap tvl,
                         float* __restrict__ o, float* __restrict__ lse, int H,
                         int Sq, int Sk, int q_off, int causal, float scale) {
  using C = Fwd<D>;
  using Regs = RegSplit<24, 240>;
  constexpr int BM = C::BM, BN = C::BN, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qh = reinterpret_cast<float*>(sm);
  float* ql = reinterpret_cast<float*>(sm + C::QL_OFF);
  float* ks = reinterpret_cast<float*>(sm + C::K_OFF);  // stage s: K_hi, K_lo
  float* vs = reinterpret_cast<float*>(sm + C::V_OFF);  // stage s: Vᵀ_hi, Vᵀ_lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int h = blockIdx.y, b = blockIdx.z;
  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int q0 = i * BM;
  const int last_row = q_off + min(q0 + BM, Sq) - 1;
  const int nk_all = (Sk + BN - 1) / BN;
  const int n_k = causal ? min(nk_all, last_row / BN + 1) : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * WG_THREADS);
      mbar_init(&v_empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps the rings full, K of tile j before
    // V of tile j
    Regs::producer();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_rows<D>(qh, &tq, q_full, BM, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % S;
        const uint32_t ph = ((j / S) & 1) ^ 1;
        float* kst = ks + s * 2 * BN * D;
        mbar_wait(&k_empty[s], ph);
        mbar_expect_tx(&k_full[s], 2 * C::KV_BYTES);
        tma_rows<D>(kst, &tkh, &k_full[s], BN, h, j * BN, b);
        tma_rows<D>(kst + BN * D, &tkl, &k_full[s], BN, h, j * BN, b);
        float* vst = vs + s * 2 * D * BN;
        mbar_wait(&v_empty[s], ph);
        mbar_expect_tx(&v_full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < BN / 32; ++p) {
          tma_load(vst + p * D * 32, &tvh, &v_full[s], j * BN + 32 * p, 0, h,
                   b);
          tma_load(vst + D * BN + p * D * 32, &tvl, &v_full[s],
                   j * BN + 32 * p, 0, h, b);
        }
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 query rows per warpgroup
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = cw * 64 + warp * 16 + g;   // the thread's first row
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const int wg_row0 = q_off + q0 + cw * 64;    // the warpgroup's first row
    const float sl2 = scale * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max of the scores, log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums
    float corr[2];
    float sc[BN / 2];
    uint32_t ph[BN / 8][4], pl[BN / 8][4];  // P split, the A operands of P·V

    // Q: the warpgroup's 64 rows split in place (hi) and beside (lo), then
    // handed to the async proxy that wgmma reads through
    mbar_wait(q_full, 0);
#pragma unroll
    for (int p = 0; p < D / 32; ++p) {
      float4* hi4 = reinterpret_cast<float4*>(qh + p * BM * 32 + cw * 64 * 32);
      float4* lo4 = reinterpret_cast<float4*>(ql + p * BM * 32 + cw * 64 * 32);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = tid + WG_THREADS * x;
        const float4 v = hi4[e];
        const Split a = split(v.x), bb = split(v.y), c = split(v.z),
                    d = split(v.w);
        hi4[e] = make_float4(__uint_as_float(a.hi), __uint_as_float(bb.hi),
                             __uint_as_float(c.hi), __uint_as_float(d.hi));
        lo4[e] = make_float4(__uint_as_float(a.lo), __uint_as_float(bb.lo),
                             __uint_as_float(c.lo), __uint_as_float(d.lo));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(3 + cw) : "memory");

    const uint64_t qhd = sw128_desc(qh + cw * 64 * 32, 16);
    const uint64_t qld = sw128_desc(ql + cw * 64 * 32, 16);
    // S = Q·Kᵀ of tile j into sc
    auto issue_s = [&](int j) {
      const float* kh = ks + (j % S) * 2 * BN * D;
      const uint64_t khd = sw128_desc(kh, 16);
      const uint64_t kld = sw128_desc(kh + BN * D, 16);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qa = kmajor_step(BM, kk), kb = kmajor_step(BN, kk);
        wgmma_ss_tf32<BN>(sc, qld + qa, khd + kb, kk > 0);
        wgmma_ss_tf32<BN>(sc, qhd + qa, kld + kb, 1);
        wgmma_ss_tf32<BN>(sc, qhd + qa, khd + kb, 1);
      }
    };
    // O += P·V of tile j
    auto issue_pv = [&](int j) {
      const float* vh = vs + (j % S) * 2 * D * BN;
      const uint64_t vhd = sw128_desc(vh, 16);
      const uint64_t vld = sw128_desc(vh + D * BN, 16);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t vb = kmajor_step(D, kk);
        wgmma_rs_tf32<D>(acc, pl[kk], vhd + vb);
        wgmma_rs_tf32<D>(acc, ph[kk], vld + vb);
        wgmma_rs_tf32<D>(acc, ph[kk], vhd + vb);
      }
    };
    auto softmax = [&](int j) {
      const bool masked = (j + 1) * BN > Sk ||
                          (causal && j * BN + BN - 1 > wg_row0);
      softmax_tile<BN>(sc, m, l, corr, sl2, masked, j * BN, Sk, causal, row,
                       t);
    };
    // P of the accumulator as the A fragments of P·V: the thread's columns
    // 2t, 2t+1 of k-step kk are logical columns t, t+4 (Vᵀ in PERM order)
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        split_frag(ph[kk], pl[kk], sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                   sc[4 * kk + 3]);
    };

    const Turns<> turns{cw};
    if (n_k > 0) {
      turns.start_kernel();
      turns.begin();
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      turns.end(false);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&k_empty[0]);
      softmax(0);
      to_a();
      for (int j = 1; j < n_k; ++j) {
        // both waits before the first wgmma: a wait between two wgmma
        // makes ptxas serialise them
        turns.begin();
        mbar_wait(&k_full[j % S], (j / S) & 1);
        mbar_wait(&v_full[(j - 1) % S], ((j - 1) / S) & 1);
        wgmma_fence();
        issue_s(j);
        wgmma_commit();
        issue_pv(j - 1);
        wgmma_commit();
        turns.end(false);
        wgmma_wait<1>();   // S of tile j is in
        fence_regs(sc);
        mbar_arrive(&k_empty[j % S]);
        softmax(j);
        wgmma_wait<0>();   // P·V of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(&v_empty[(j - 1) % S]);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c] *= corr[0];
          acc[4 * c + 1] *= corr[0];
          acc[4 * c + 2] *= corr[1];
          acc[4 * c + 3] *= corr[1];
        }
        to_a();
      }
      turns.begin();
      mbar_wait(&v_full[(n_k - 1) % S], ((n_k - 1) / S) & 1);
      wgmma_fence();
      issue_pv(n_k - 1);
      wgmma_commit();
      turns.end(true);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&v_empty[(n_k - 1) % S]);
    }

    // Flush: a row that saw no key (l == 0) gets output 0, as the reference.
    float lse_r[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      inv[r] = lr == 0.f ? 1.f : 1.f / lr;
      lse_r[r] = m[r] == NEG_INF ? NEG_INF
                                 : m[r] * LN2 + logf(lr == 0.f ? 1.f : lr);
    }
    float* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + r_loc + 8 * half;
      if (r >= Sq) continue;
      float* p = ob + static_cast<size_t>(r) * H * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(p + 8 * c) =
            make_float2(acc[4 * c + 2 * half] * inv[half],
                        acc[4 * c + 2 * half + 1] * inv[half]);
    }
    if (t == 0) {
      float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      if (q0 + r_loc < Sq) lb[q0 + r_loc] = lse_r[0];
      if (q0 + r_loc + 8 < Sq) lb[q0 + r_loc + 8] = lse_r[1];
    }
    trap_if_stalled();
  }
}

// K1's scratch: K_hi, K_lo ([B, Sk, H, D] each), Vᵀ_hi, Vᵀ_lo ([B, H, D,
// SkP] each), in that order: 2·B·H·D·(Sk + SkP) floats. make() also builds
// the tensor maps of K1's tiles over it: K_hi and K_lo in boxes of `bn`
// rows, Vᵀ_hi and Vᵀ_lo in boxes of 32 keys by `vrows` columns of D.
struct SplitKV {
  int SkP;
  float *kh, *kl, *vth, *vtl;
  CUtensorMap tkh, tkl, tvh, tvl;

  int make(void* scratch, int B, int H, int Sk, int D, int bn, int vrows) {
    SkP = (Sk + 7) / 8 * 8;
    kh = static_cast<float*>(scratch);
    kl = kh + static_cast<size_t>(B) * Sk * H * D;
    vth = kl + static_cast<size_t>(B) * Sk * H * D;
    vtl = vth + static_cast<size_t>(B) * H * D * SkP;
    int err = rows_map(&tkh, kh, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tkl, kl, B, Sk, H, D, bn);
    // Vᵀ: coordinates (key, column, h, b)
    if (!err) err = make_map(&tvh, vth, {SkP, D, H, B}, {32, vrows, 1, 1});
    if (!err) err = make_map(&tvl, vtl, {SkP, D, H, B}, {32, vrows, 1, 1});
    return err;
  }

  // The prologue: K and V split into the scratch.
  int launch(const void* k, const void* v, int B, int H, int Sk, int D,
             cudaStream_t st) const {
    flash_f32_split_kernel<<<dim3((SkP + PT - 1) / PT, D / PT, B * H), 256,
                             0, st>>>(static_cast<const float*>(k),
                                      static_cast<const float*>(v), kh, kl,
                                      vth, vtl, H, Sk, SkP, D);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               void* scratch, int B, int H, int Sq, int Sk, int q_off,
               int causal, float scale, cudaStream_t st) {
  using C = Fwd<D>;
  SplitKV kv;
  CUtensorMap tq;
  int err = rows_map(&tq, q, B, Sq, H, D, C::BM);
  if (!err) err = kv.make(scratch, B, H, Sk, D, C::BN, D);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_fwd_f32_kernel<D>), C::SMEM);
  if (!err) err = kv.launch(k, v, B, H, Sk, D, st);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, H, B);
  flash_fwd_f32_kernel<D><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, kv.tkh, kv.tkl, kv.tvh, kv.tvl, static_cast<float*>(o),
      static_cast<float*>(lse), H, Sq, Sk, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Above D=128: K1 streaming D
// ---------------------------------------------------------------------------
//
// The kernel takes every D that is a multiple of 128 (the JAX package's
// wide widths) at one instantiation, CW = 128: a CTA owns CW columns of the
// output (the grid's x axis), and S, which sums over all of D, streams D
// through a TMA ring in chunks of KC = 32 columns, one 128-byte swizzle
// part. Each of the D/CW CTAs of a row block computes the same S, so the
// products do (D/CW + 1)/2 times the operations of the bound: 1.5 at D=256,
// 2 at 384, 2.5 at 512.

// K1 above 128 (flash_fwd_f32_wide_kernel): flash_fwd_f32_kernel's three
// TF32 passes and warp specialisation on flash_fwd_wide.cu's chunked
// schedule (flash_fwd_chunked_kernel).
// - A stage holds the chunk of Q's 128 rows, raw as TMA brings it, and of
//   K_hi and K_lo's BN rows (the prologue's scratch, as at D ≤ 128). Each
//   consumer warpgroup splits its 64 rows of the chunk's Q, hi in place and
//   lo beside it, then issues S += Q·Kᵀ over the chunk's four k-steps in
//   three passes (wgmma m64nBNk8 from shared memory). Q is read again from
//   L2 and split again for every key tile: resident, Q_hi and Q_lo would
//   take 128 KB a 64 rows at D=256 and more than the SM holds from 384.
// - Then the online softmax, P split in registers as the A operand of
//   O += P·Vᵀ (wgmma m64nCWk8, Vᵀ_hi and Vᵀ_lo over the CTA's CW columns),
//   as at D ≤ 128. One V stage: V of tile j loads while S of tile j+1 sums
//   over its D/32 chunks, so the producer issues the chunks of tile j+1
//   before V of tile j, in the order the consumers take them.
// - No turns, as in the chunked kernel: both warpgroups read every stage.
// Shared memory (plus 1 KB to align the base, and the mbarriers):
//   3 × (Q 16 KB + Q_lo 16 KB + K_hi 8 KB + K_lo 8 KB) + Vᵀ_hi, Vᵀ_lo 2 ×
//   32 KB = 208 KB.
// Registers (setmaxnreg: 24 a producer, 240 a consumer thread): O CW/2 =
// 64 fp32, S BN/2 = 32, P's hi and lo BN/2 = 64 TF32 values.
template <int CW>
struct FwdF32Wide {
  static constexpr int BM = 128;  // query rows of a CTA
  static constexpr int BN = 64;   // keys of a tile
  static constexpr int KC = 32;   // columns of D in a stage
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * KC * 4;  // each of Q (then Q_hi), Q_lo
  static constexpr int K_BYTES = BN * KC * 4;  // each of K_hi, K_lo
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 2 * K_BYTES;
  static constexpr int V_BYTES = CW * BN * 4;  // each of Vᵀ_hi, Vᵀ_lo
  static constexpr int V_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = V_OFF + 2 * V_BYTES;
  // full[STAGES], empty[STAGES], v_full, v_empty
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 2);
  static_assert(SMEM <= MAX_SMEM, "K1's ring exceeds shared memory");
};

template <int CW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tkh,
                              const __grid_constant__ CUtensorMap tkl,
                              const __grid_constant__ CUtensorMap tvh,
                              const __grid_constant__ CUtensorMap tvl,
                              float* __restrict__ o, float* __restrict__ lse,
                              int H, int Sq, int Sk, int D, int q_off,
                              int causal, float scale) {
  using C = FwdF32Wide<CW>;
  using Regs = RegSplit<24, 240>;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: Q (raw, then Q_hi), Q_lo, K_hi, K_lo
  auto stage = [&](int s) {
    return reinterpret_cast<float*>(sm + s * C::STAGE_BYTES);
  };
  float* vs = reinterpret_cast<float*>(sm + C::V_OFF);  // Vᵀ_hi, Vᵀ_lo
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* v_full = empty + ST;
  uint64_t* v_empty = v_full + 1;

  const int c0 = blockIdx.x * CW;            // the CTA's columns of O
  const int i = gridDim.y - 1 - blockIdx.y;  // longest query tiles first
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int q0 = i * BM;
  const int last_row = q_off + min(q0 + BM, Sq) - 1;
  const int nk_all = (Sk + BN - 1) / BN;
  const int n_k = causal ? min(nk_all, last_row / BN + 1) : nk_all;
  const int nc = D / KC;  // chunks of D a tile's S sums over

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 2 * WG_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring and the V stage full, in the
    // order the consumers take them: tile j+1's chunks, then V of tile j
    Regs::producer();
    if (threadIdx.x == 0 && n_k > 0) {
      int it = 0;  // chunks issued
      auto load_chunks = [&](int j) {
        for (int c = 0; c < nc; ++c, ++it) {
          const int s = it % ST;
          float* st = stage(s);
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::Q_BYTES + 2 * C::K_BYTES);
          tma_load(st, &tq, &full[s], c * KC, h, q0, b);
          tma_load(st + 2 * BM * KC, &tkh, &full[s], c * KC, h, j * BN, b);
          tma_load(st + 2 * BM * KC + BN * KC, &tkl, &full[s], c * KC, h,
                   j * BN, b);
        }
      };
      auto load_v = [&](int j) {
        mbar_wait(v_empty, (j & 1) ^ 1);
        mbar_expect_tx(v_full, 2 * C::V_BYTES);
#pragma unroll
        for (int p = 0; p < BN / 32; ++p) {
          tma_load(vs + p * CW * 32, &tvh, v_full, j * BN + 32 * p, c0, h, b);
          tma_load(vs + CW * BN + p * CW * 32, &tvl, v_full,
                   j * BN + 32 * p, c0, h, b);
        }
      };
      load_chunks(0);
      for (int j = 1; j < n_k; ++j) {
        load_chunks(j);
        load_v(j - 1);
      }
      load_v(n_k - 1);
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 query rows per warpgroup
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = cw * 64 + warp * 16 + g;  // the thread's first row
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const int wg_row0 = q_off + q0 + cw * 64;   // the warpgroup's first row
    const float sl2 = scale * LOG2E;

    float acc[CW / 2];
#pragma unroll
    for (int e = 0; e < CW / 2; ++e) acc[e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max of the scores, log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums
    float corr[2];
    float sc[BN / 2];
    uint32_t ph[BN / 8][4], pl[BN / 8][4];  // P split, the A operands of P·V

    // The products of chunk `it` (of all the tiles' chunks) into sc, as one
    // commit group; the first chunk of a tile (`first`, a constant at each
    // call) overwrites sc. The warpgroup first splits its 64 rows of the
    // chunk's Q (hi in place, lo beside) and hands them to the async proxy.
    auto issue_chunk = [&](int it, bool first) {
      const int s = it % ST;
      float* qhi = stage(s) + cw * 64 * KC;
      float* qlo = qhi + BM * KC;
      const float* khi = stage(s) + 2 * BM * KC;
      mbar_wait(&full[s], (it / ST) & 1);
#pragma unroll
      for (int x = 0; x < 64 * KC / 4 / WG_THREADS; ++x) {
        const int e = tid + WG_THREADS * x;
        const float4 v = reinterpret_cast<const float4*>(qhi)[e];
        const Split a = split(v.x), bb = split(v.y), c = split(v.z),
                    d = split(v.w);
        reinterpret_cast<float4*>(qhi)[e] =
            make_float4(__uint_as_float(a.hi), __uint_as_float(bb.hi),
                        __uint_as_float(c.hi), __uint_as_float(d.hi));
        reinterpret_cast<float4*>(qlo)[e] =
            make_float4(__uint_as_float(a.lo), __uint_as_float(bb.lo),
                        __uint_as_float(c.lo), __uint_as_float(d.lo));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      const uint64_t qhid = sw128_desc(qhi, 16), qlod = sw128_desc(qlo, 16);
      const uint64_t khid = sw128_desc(khi, 16);
      const uint64_t klod = sw128_desc(khi + BN * KC, 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint32_t qs = kmajor_step(BM, kk), ks = kmajor_step(BN, kk);
        wgmma_ss_tf32<BN>(sc, qlod + qs, khid + ks, !first || kk > 0);
        wgmma_ss_tf32<BN>(sc, qhid + qs, klod + ks, 1);
        wgmma_ss_tf32<BN>(sc, qhid + qs, khid + ks, 1);
      }
      wgmma_commit();
    };
    // S = Q·Kᵀ of tile j into sc, summed over the nc chunks of D as they
    // arrive; each chunk's stage is released once the next chunk is issued
    // and its own products are done, the last chunk's by release_s. The
    // first chunk is issued apart, so that no branch stands around the wait
    // in the loop (one made ptxas serialise every wgmma, flash_fwd_wide.cu).
    auto issue_s = [&](int j) {
      issue_chunk(j * nc, true);
      for (int c = 1; c < nc; ++c) {
        issue_chunk(j * nc + c, false);
        wgmma_wait<1>();
        mbar_arrive(&empty[(j * nc + c - 1) % ST]);
      }
    };
    auto release_s = [&](int j) {
      mbar_arrive(&empty[(j * nc + nc - 1) % ST]);
    };
    // O += P·Vᵀ of tile j over the CTA's columns, as one commit group
    auto issue_pv = [&](int j) {
      mbar_wait(v_full, j & 1);
      const uint64_t vhid = sw128_desc(vs, 16);
      const uint64_t vlod = sw128_desc(vs + CW * BN, 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t vk = kmajor_step(CW, kk);
        wgmma_rs_tf32<CW>(acc, pl[kk], vhid + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vlod + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vhid + vk);
      }
      wgmma_commit();
    };
    auto softmax = [&](int j) {
      const bool masked =
          (j + 1) * BN > Sk || (causal && j * BN + BN - 1 > wg_row0);
      softmax_tile<BN>(sc, m, l, corr, sl2, masked, j * BN, Sk, causal, row,
                       t);
    };
    // P of the accumulator as the A fragments of P·V (Vᵀ in PERM order)
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        split_frag(ph[kk], pl[kk], sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                   sc[4 * kk + 3]);
    };

    if (n_k > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      release_s(0);
      softmax(0);
      to_a();
      for (int j = 1; j < n_k; ++j) {
        issue_s(j);
        issue_pv(j - 1);
        wgmma_wait<1>();  // S of tile j is in
        fence_regs(sc);
        release_s(j);
        softmax(j);
        wgmma_wait<0>();  // P·V of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(v_empty);
        // O's rows to the new max: element e is row half (e >> 1) & 1
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
        to_a();
      }
      issue_pv(n_k - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty);
    }

    // Flush: a row that saw no key (l == 0) gets output 0, as the reference.
    float lse_r[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      inv[r] = lr == 0.f ? 1.f : 1.f / lr;
      lse_r[r] = m[r] == NEG_INF ? NEG_INF
                                 : m[r] * LN2 + logf(lr == 0.f ? 1.f : lr);
    }
    float* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D + c0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + r_loc + 8 * half;
      if (r >= Sq) continue;
      float* p = ob + static_cast<size_t>(r) * H * D + 2 * t;
#pragma unroll
      for (int c = 0; c < CW / 8; ++c)
        *reinterpret_cast<float2*>(p + 8 * c) =
            make_float2(acc[4 * c + 2 * half] * inv[half],
                        acc[4 * c + 2 * half + 1] * inv[half]);
    }
    if (t == 0 && blockIdx.x == 0) {
      float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      if (q0 + r_loc < Sq) lb[q0 + r_loc] = lse_r[0];
      if (q0 + r_loc + 8 < Sq) lb[q0 + r_loc + 8] = lse_r[1];
    }
    trap_if_stalled();
  }
}

template <int CW>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o,
                    void* lse, void* scratch, int B, int H, int Sq, int Sk,
                    int D, int q_off, int causal, float scale,
                    cudaStream_t st) {
  using C = FwdF32Wide<CW>;
  SplitKV kv;
  CUtensorMap tq;
  int err = rows_map(&tq, q, B, Sq, H, D, C::BM);
  if (!err) err = kv.make(scratch, B, H, Sk, D, C::BN, CW);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_fwd_f32_wide_kernel<CW>),
        C::SMEM);
  if (!err) err = kv.launch(k, v, B, H, Sk, D, st);
  if (err) return err;
  const dim3 grid(D / CW, (Sq + C::BM - 1) / C::BM, B * H);
  flash_fwd_f32_wide_kernel<CW><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, kv.tkh, kv.tkl, kv.tvh, kv.tvl, static_cast<float*>(o),
      static_cast<float*>(lse), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2: dQ and δ, at every width
// ---------------------------------------------------------------------------
//
// flash_dq_f32_kernel computes what `_dq_kernel` computes: with P =
// exp(S·scale − lse) from the forward's lse and δ = rowsum(dO∘O), dS =
// P∘(dO·Vᵀ − δ)·scale and dQ = Σ_j dS·K_j; it writes δ to `delta` for K3.
// Bound on an H100 SXM at B=8, H=16, S=2048, D=64, causal: three products
// of 34.4 GFLOP (S, dP, dS·K), 0.625 ms at 495/3 TFLOP/s, against six
// [B,S,H,D] fp32 tensors and two row statistics ≈ 202 MB, 0.060 ms:
// bound by operations (the same at B=8, H=4, D=256).
//
// One design takes every width: D=128 must stream D in any case (Q and dO
// resident and split would take 256 KB at 128 rows), and D=64 is the same
// kernel with CW=64. flash_dq_wide.cu's flash_dq_chunked_kernel schedule in
// three TF32 passes, with the work split between the warpgroups by rows:
// - A CTA owns BM = 128 query rows of one (b, h), 64 a consumer warpgroup,
//   and CW = min(D, 128) columns of dQ (the grid's x axis, fastest, so the
//   CTAs of a row block read the same chunks from L2 together). One
//   producer warp issues every TMA load.
// - A prologue (flash_f32_split_dq_kernel, launched by the same C entry)
//   writes K_hi, K_lo, V_hi and V_lo ([B, Sk, H, D]) and Kᵀ_hi, Kᵀ_lo ([B,
//   H, D, SkP], keys contiguous in the order PERM within each group of 8)
//   into scratch that the wrapper allocates, six times K's bytes.
// - For each tile of BN = 64 keys, S = Q·Kᵀ and dP = dO·Vᵀ sum over D in
//   KC = 32-column chunks (one 128-byte swizzle part) through a ring of two
//   stages, each holding the chunk of Q and dO (128 rows, raw as TMA brings
//   them) and of K_hi, K_lo, V_hi and V_lo. Each consumer warpgroup splits
//   its 64 rows of the chunk's Q and dO in shared memory, hi in place and
//   lo into a buffer of its own, as K1 splits Q, and issues both products
//   in three passes (wgmma m64n64k8, both operands from shared memory).
// - Each chunk's products go into accumulators of their own, one commit
//   group, which once done (wgmma_wait<0>) releases the chunk's stage and
//   adds into the tile's S and dP in fp32 on the CUDA cores: the tensor
//   cores truncate their fp32 sums at every k-step, and a query row that
//   sees one key has dP − δ cancel (flash_dq_chunked_kernel's finding, at
//   4.8e-3 against a 5e-3 bar in fp16 with one accumulator over all of
//   D). The warpgroup waits on its own products a chunk; the other
//   warpgroup's fill the tensor cores meanwhile.
// - Then P·scale = exp2(S·scale·log2e − lse2), lse2 = lse·log2e − log2
//   scale (the scale rides in the exponent, as in K1), dS = P·scale∘(dP −
//   δ) on the accumulator, split into TF32 halves: with Kᵀ's keys in PERM
//   order the accumulator pair of each k-step is its A fragment, as P is in
//   K1's P·V. dQ += dS_lo·Kᵀ_hi + dS_hi·Kᵀ_lo + dS_hi·Kᵀ_hi (wgmma
//   m64nCWk8, A from registers) over the CTA's CW columns, dQ in registers;
//   Kᵀ's tile (CW × BN, hi and lo) has a stage of its own, loaded once the
//   ring holds the tile's first chunks and released after the product.
// - δ: each warpgroup computes it for its rows before the first tile, from
//   O and dO read from device memory in one fixed order (thread t of a quad
//   takes the 16-byte chunks t, t + 4, … of the row, the quad sums), so
//   every CTA of a row block holds the same δ, bitwise; the CTA of columns
//   0 writes it out. No atomics: each CTA writes its own rows of dQ.
// - Why by rows, not flash_dq_chunked_kernel's split by operand (one
//   warpgroup S, the other dP, P and dS handed across): that exchange, 32
//   KB of fp32 at 128 rows, does not fit beside this ring, and at 64 rows a
//   CTA would read K, V and Kᵀ from L2 twice as often (8.6 GB against 5.6
//   at the D=64 shape). By rows, no warpgroup waits on the other.
// - Each of the D/CW CTAs of a row block computes the same S, dP and dS,
//   so the products do (2·D/CW + 1)/3 of the bound's operations (5/3 at
//   D=256), the price of one dS per row without atomics. Q and dO are read
//   again for every key tile, from L2.
// - Causal: key tiles past the block's last row are never loaded; only
//   tiles that cross the diagonal or the ragged end of Sk are masked. The
//   query tiles run longest first. Rows past Sq arrive from TMA as zeros,
//   take lse 0 and δ 0 (so dS = 0) and are never stored; keys past Sk
//   arrive as zeros and are masked.
// Shared memory (plus 1 KB to align the base, and the mbarriers):
//   2 × (Q, dO 16 KB each + K_hi, K_lo, V_hi, V_lo 8 KB each) + Q_lo and
//   dO_lo of each warpgroup 4 × 8 KB + Kᵀ_hi, Kᵀ_lo 2 × CW × BN × 4
//   = 224 KB at CW=128, 192 KB at CW=64.
// Registers (setmaxnreg: 24 a producer, 240 a consumer thread): dQ CW/2
// fp32, S and dP BN/2 = 32 each, a chunk's products of each 32 more; dS's
// hi and lo fragments (BN/2 each) take the place of S, dP and the products.
// ptxas spills nothing at CW=64 or 128 (chip_smoke.py phase 2 gates both).
// Where the time goes (scripts/torch_f32_ablate.py on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit, B=8, S=2048, causal; D=64 with H=16, then
// D=256 with H=4): the split of Q and dO, redone for every key tile, 26%
// and 32%; the lo passes 24% and 27%; the prologue 11% and 8%; the loads
// 0-3%. Splitting the next chunk under this chunk's products (a second set
// of lo buffers, which fits at CW=64 alone) and turns between the
// warpgroups made it no faster: the split costs shared-memory throughput
// beside the products, not latency.

// K2's prologue: K_hi, K_lo, V_hi, V_lo as [B, Sk, H, D] and Kᵀ_hi, Kᵀ_lo as
// [B, H, D, SkP] (keys contiguous in the order PERM within each group of 8,
// zeros past Sk).
__global__ void __launch_bounds__(256)
    flash_f32_split_dq_kernel(const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ kh, float* __restrict__ kl,
                              float* __restrict__ vh, float* __restrict__ vl,
                              float* __restrict__ kth, float* __restrict__ ktl,
                              int H, int Sk, int SkP, int D) {
  __shared__ float tile[PT][PT + 1];  // K[key0 + r][d0 + c]
  const int key0 = blockIdx.x * PT, d0 = blockIdx.y * PT;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const int key = key0 + r;
    float x = 0.f;
    if (key < Sk) {
      const size_t i =
          ((static_cast<size_t>(b) * Sk + key) * H + h) * D + d0 + tx;
      x = k[i];
      const Split s = split(x), sv = split(v[i]);
      kh[i] = __uint_as_float(s.hi);
      kl[i] = __uint_as_float(s.lo);
      vh[i] = __uint_as_float(sv.hi);
      vl[i] = __uint_as_float(sv.lo);
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  const int pos = key0 + tx;
  if (pos >= SkP) return;
  const int src = (tx & ~7) + perm8(tx & 7);
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const Split s = split(tile[src][r]);
    const size_t i =
        ((static_cast<size_t>(b) * H + h) * D + d0 + r) * SkP + pos;
    kth[i] = __uint_as_float(s.hi);
    ktl[i] = __uint_as_float(s.lo);
  }
}

// K2's scratch: K_hi, K_lo, V_hi, V_lo ([B, Sk, H, D] each), Kᵀ_hi, Kᵀ_lo
// ([B, H, D, SkP] each), in that order: 2·B·H·D·(2·Sk + SkP) floats. make()
// also builds the tensor maps of K2's tiles over it: the first four in
// boxes of `bn` rows, Kᵀ_hi and Kᵀ_lo in boxes of 32 keys by `cw` columns
// of D.
struct SplitDq {
  int SkP;
  float *kh, *kl, *vh, *vl, *kth, *ktl;
  CUtensorMap tkh, tkl, tvh, tvl, tth, ttl;

  int make(void* scratch, int B, int H, int Sk, int D, int bn, int cw) {
    SkP = (Sk + 7) / 8 * 8;
    const size_t n = static_cast<size_t>(B) * Sk * H * D;
    kh = static_cast<float*>(scratch);
    kl = kh + n;
    vh = kl + n;
    vl = vh + n;
    kth = vl + n;
    ktl = kth + static_cast<size_t>(B) * H * D * SkP;
    int err = rows_map(&tkh, kh, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tkl, kl, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tvh, vh, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tvl, vl, B, Sk, H, D, bn);
    // Kᵀ: coordinates (key, column, h, b)
    if (!err) err = make_map(&tth, kth, {SkP, D, H, B}, {32, cw, 1, 1});
    if (!err) err = make_map(&ttl, ktl, {SkP, D, H, B}, {32, cw, 1, 1});
    return err;
  }

  // The prologue: K and V split into the scratch.
  int launch(const void* k, const void* v, int B, int H, int Sk, int D,
             cudaStream_t st) const {
    flash_f32_split_dq_kernel<<<dim3((SkP + PT - 1) / PT, D / PT, B * H), 256,
                                0, st>>>(static_cast<const float*>(k),
                                         static_cast<const float*>(v), kh, kl,
                                         vh, vl, kth, ktl, H, Sk, SkP, D);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CW>
struct DqF32 {
  static constexpr int BM = 128;  // query rows of a CTA, 64 a warpgroup
  static constexpr int BN = 64;   // keys of a tile
  static constexpr int KC = 32;   // columns of D in a stage
  static constexpr int STAGES = 2;
  static constexpr int T_BYTES = BM * KC * 4;   // a chunk of Q or dO
  static constexpr int KV_BYTES = BN * KC * 4;  // of K_hi, K_lo, V_hi, V_lo
  static constexpr int STAGE_BYTES = 2 * T_BYTES + 4 * KV_BYTES;
  static constexpr int LO_BYTES = 64 * KC * 4;  // a warpgroup's Q_lo, dO_lo
  static constexpr int KT_BYTES = CW * BN * 4;  // each of Kᵀ_hi, Kᵀ_lo
  static constexpr int LO_OFF = STAGES * STAGE_BYTES;
  static constexpr int KT_OFF = LO_OFF + 4 * LO_BYTES;
  static constexpr int BAR_OFF = KT_OFF + 2 * KT_BYTES;
  // full[STAGES], empty[STAGES], kt_full, kt_empty
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 2);
  static_assert(SMEM <= MAX_SMEM, "K2's ring exceeds shared memory");
};

template <int CW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tkh,
                        const __grid_constant__ CUtensorMap tkl,
                        const __grid_constant__ CUtensorMap tvh,
                        const __grid_constant__ CUtensorMap tvl,
                        const __grid_constant__ CUtensorMap tth,
                        const __grid_constant__ CUtensorMap ttl,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int H, int Sq, int Sk, int D, int q_off, int causal,
                        float scale) {
  using C = DqF32<CW>;
  using Regs = RegSplit<24, 240>;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: Q (raw, then Q_hi), dO (raw, then dO_hi), K_hi, K_lo, V_hi,
  // V_lo over one chunk of D
  auto stage = [&](int s) {
    return reinterpret_cast<float*>(sm + s * C::STAGE_BYTES);
  };
  float* lo = reinterpret_cast<float*>(sm + C::LO_OFF);  // [wg][Q_lo, dO_lo]
  float* kt = reinterpret_cast<float*>(sm + C::KT_OFF);  // Kᵀ_hi, Kᵀ_lo
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* kt_full = empty + ST;
  uint64_t* kt_empty = kt_full + 1;

  const int c0 = blockIdx.x * CW;            // the CTA's columns of dQ
  const int i = gridDim.y - 1 - blockIdx.y;  // longest query tiles first
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int q0 = i * BM;
  const int last_row = q_off + min(q0 + BM, Sq) - 1;
  const int nk_all = (Sk + BN - 1) / BN;
  const int n_k = causal ? min(nk_all, last_row / BN + 1) : nk_all;
  const int nc = D / KC;  // chunks of D a tile's S and dP sum over

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init(kt_full, 1);
    mbar_init(kt_empty, 2 * WG_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring and Kᵀ's stage full, in the
    // order the consumers take them
    Regs::producer();
    if (threadIdx.x == 0) {
      const int kt_at = min(ST, nc) - 1;  // the chunk after which Kᵀ's tile
      int it = 0;                         // chunks issued
      for (int j = 0; j < n_k; ++j) {
        for (int c = 0; c < nc; ++c, ++it) {
          const int s = it % ST;
          float* st = stage(s);
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_load(st, &tq, &full[s], c * KC, h, q0, b);
          tma_load(st + BM * KC, &tdo, &full[s], c * KC, h, q0, b);
          float* kv = st + 2 * BM * KC;
          tma_load(kv, &tkh, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + BN * KC, &tkl, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + 2 * BN * KC, &tvh, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + 3 * BN * KC, &tvl, &full[s], c * KC, h, j * BN, b);
          if (c == kt_at) {
            // the ring is full of this tile's chunks: the consumers are done
            // with the last tile's dQ, or soon will be
            mbar_wait(kt_empty, (j & 1) ^ 1);
            mbar_expect_tx(kt_full, 2 * C::KT_BYTES);
#pragma unroll
            for (int p = 0; p < BN / 32; ++p) {
              tma_load(kt + p * CW * 32, &tth, kt_full, j * BN + 32 * p, c0,
                       h, b);
              tma_load(kt + CW * BN + p * CW * 32, &ttl, kt_full,
                       j * BN + 32 * p, c0, h, b);
            }
          }
        }
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 query rows per warpgroup, S, dP, dS and dQ each
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = cw * 64 + warp * 16 + g;  // the thread's first row
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const int wg_row0 = q_off + q0 + cw * 64;   // the warpgroup's first row
    const float sl2 = scale * LOG2E;
    const int rs = H * D;
    const size_t head = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

    // lse of the thread's rows as lse·log2e − log2 scale, so that
    // exp2(S·sl2 − lse2) = P·scale, and δ over all of D (float4 chunks t,
    // t + 4, … of the row, the quad summing); 0 past Sq
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = q0 + r_loc + 8 * r;
      float s = 0.f;
      lse2[r] = 0.f;
      if (gr < Sq) {
        lse2[r] = fmaf(lse[stat + gr], LOG2E, -log2f(scale));
        const size_t at = head + static_cast<size_t>(gr) * rs;
        const float4* orow = reinterpret_cast<const float4*>(o + at);
        const float4* drow = reinterpret_cast<const float4*>(dout + at);
#pragma unroll 4
        for (int x = t; x < D / 4; x += 4) {
          const float4 a = __ldg(drow + x), c = __ldg(orow + x);
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
          s = fmaf(a.z, c.z, s);
          s = fmaf(a.w, c.w, s);
        }
      }
      dl[r] = quad_sum(s);
      if (t == 0 && gr < Sq && blockIdx.x == 0) delta[stat + gr] = dl[r];
    }

    float acc[CW / 2];
#pragma unroll
    for (int e = 0; e < CW / 2; ++e) acc[e] = 0.f;
    float sc[BN / 2], dp[BN / 2];  // S (then dS) and dP of the tile
    float ps[BN / 2], pp[BN / 2];  // a chunk's products of S and dP
    float* qlo = lo + 2 * cw * 64 * KC;
    float* dolo = qlo + 64 * KC;

    // The warpgroup's 64 rows of a chunk of Q or dO at `hi` split: hi in
    // place, lo into `lo_`
    auto split_rows = [&](float* hi, float* lo_) {
#pragma unroll
      for (int x = 0; x < 64 * KC / 4 / WG_THREADS; ++x) {
        const int e = tid + WG_THREADS * x;
        const float4 v = reinterpret_cast<const float4*>(hi)[e];
        const Split a = split(v.x), bb = split(v.y), c = split(v.z),
                    d = split(v.w);
        reinterpret_cast<float4*>(hi)[e] =
            make_float4(__uint_as_float(a.hi), __uint_as_float(bb.hi),
                        __uint_as_float(c.hi), __uint_as_float(d.hi));
        reinterpret_cast<float4*>(lo_)[e] =
            make_float4(__uint_as_float(a.lo), __uint_as_float(bb.lo),
                        __uint_as_float(c.lo), __uint_as_float(d.lo));
      }
    };
    // The products of chunk `it` (of all the tiles' chunks) into ps and pp,
    // committed as one group: S = Q·Kᵀ and dP = dO·Vᵀ over the chunk's KC
    // columns, after the warpgroup has split its rows of Q and dO and
    // handed them to the async proxy.
    auto issue_chunk = [&](int it) {
      const int s = it % ST;
      float* qhi = stage(s) + cw * 64 * KC;
      float* dohi = qhi + BM * KC;
      const float* khi = stage(s) + 2 * BM * KC;
      mbar_wait(&full[s], (it / ST) & 1);
      split_rows(qhi, qlo);
      split_rows(dohi, dolo);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      const uint64_t qhd = sw128_desc(qhi, 16), qld = sw128_desc(qlo, 16);
      const uint64_t dhd = sw128_desc(dohi, 16), dld = sw128_desc(dolo, 16);
      const uint64_t khd = sw128_desc(khi, 16);
      const uint64_t kld = sw128_desc(khi + BN * KC, 16);
      const uint64_t vhd = sw128_desc(khi + 2 * BN * KC, 16);
      const uint64_t vld = sw128_desc(khi + 3 * BN * KC, 16);
      // the small terms of the chunk first, then hi·hi: a term the tensor
      // cores add truncates the sum at the sum's own magnitude, so the
      // products near the sum's size come last and fewest
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint32_t a = kmajor_step(64, kk), bk = kmajor_step(BN, kk);
        wgmma_ss_tf32<BN>(ps, qld + a, khd + bk, kk > 0);
        wgmma_ss_tf32<BN>(ps, qhd + a, kld + bk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk)
        wgmma_ss_tf32<BN>(ps, qhd + kmajor_step(64, kk),
                          khd + kmajor_step(BN, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint32_t a = kmajor_step(64, kk), bk = kmajor_step(BN, kk);
        wgmma_ss_tf32<BN>(pp, dld + a, vhd + bk, kk > 0);
        wgmma_ss_tf32<BN>(pp, dhd + a, vld + bk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk)
        wgmma_ss_tf32<BN>(pp, dhd + kmajor_step(64, kk),
                          vhd + kmajor_step(BN, kk), 1);
      wgmma_commit();
    };

    for (int j = 0; j < n_k; ++j) {
      // S and dP of tile j, summed over the nc chunks of D as they arrive:
      // each chunk's products, once done, release its stage and add into
      // sc and dp in fp32 (header)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = dp[e] = 0.f;
      for (int c = 0; c < nc; ++c) {
        issue_chunk(j * nc + c);
        wgmma_wait<0>();
        fence_regs(ps);
        fence_regs(pp);
        mbar_arrive(&empty[(j * nc + c) % ST]);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          sc[e] += ps[e];
          dp[e] += pp[e];
        }
      }
      // P·scale, then dS = P·scale∘(dP − δ) in place of S; the mask is a
      // pass of its own behind a uniform branch
      const int k0 = j * BN;
      if (k0 + BN > Sk || (causal && k0 + BN - 1 > wg_row0)) {
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * c + 2 * t + (e & 1);
            if (col >= Sk || (causal && row[e >> 1] < col))
              sc[4 * c + e] = NEG_INF;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        sc[e] = fast_exp2(fmaf(sc[e], sl2, -lse2[(e >> 1) & 1])) *
                (dp[e] - dl[(e >> 1) & 1]);
      // dS split as the A fragments of dQ's product: the thread's columns
      // 2t, 2t+1 of k-step kk are logical columns t, t+4 (Kᵀ in PERM order)
      uint32_t dsh[BN / 8][4], dsl[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        split_frag(dsh[kk], dsl[kk], sc[4 * kk], sc[4 * kk + 2],
                   sc[4 * kk + 1], sc[4 * kk + 3]);
      // dQ += dS·K over the CTA's columns: Kᵀ_hi, Kᵀ_lo K-major
      mbar_wait(kt_full, j & 1);
      const uint64_t thd = sw128_desc(kt, 16);
      const uint64_t tld = sw128_desc(kt + CW * BN, 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t bk = kmajor_step(CW, kk);
        wgmma_rs_tf32<CW>(acc, dsl[kk], thd + bk);
        wgmma_rs_tf32<CW>(acc, dsh[kk], tld + bk);
        wgmma_rs_tf32<CW>(acc, dsh[kk], thd + bk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(kt_empty);
    }

    // dQ of the thread's rows, columns c0 + 8c + 2t, 2t + 1
    float* qb = dq + head + c0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + r_loc + 8 * half;
      if (r >= Sq) continue;
      float* p = qb + static_cast<size_t>(r) * rs + 2 * t;
#pragma unroll
      for (int c = 0; c < CW / 8; ++c)
        *reinterpret_cast<float2*>(p + 8 * c) =
            make_float2(acc[4 * c + 2 * half], acc[4 * c + 2 * half + 1]);
    }
    trap_if_stalled();
  }
}

template <int CW>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              void* scratch, int B, int H, int Sq, int Sk, int D, int q_off,
              int causal, float scale, cudaStream_t st) {
  using C = DqF32<CW>;
  SplitDq kv;
  CUtensorMap tq, tdo;
  int err = rows_map(&tq, q, B, Sq, H, D, C::BM);
  if (!err) err = rows_map(&tdo, dout, B, Sq, H, D, C::BM);
  if (!err) err = kv.make(scratch, B, H, Sk, D, C::BN, CW);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dq_f32_kernel<CW>), C::SMEM);
  if (!err) err = kv.launch(k, v, B, H, Sk, D, st);
  if (err) return err;
  const dim3 grid(D / CW, (Sq + C::BM - 1) / C::BM, B * H);
  flash_dq_f32_kernel<CW><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tdo, kv.tkh, kv.tkl, kv.tvh, kv.tvl, kv.tth, kv.ttl,
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3: dK and dV, at every width
// ---------------------------------------------------------------------------
//
// flash_dkv_f32_kernel computes what `_dkv_kernel` computes: with Pᵀ =
// exp(Sᵀ·scale − lse), Sᵀ = K·Qᵀ, from the forward's lse and K2's δ, and
// dSᵀ = Pᵀ∘(dPᵀ − δ)·scale, dPᵀ = V·dOᵀ: dV = Σ Pᵀ·dO and dK = Σ dSᵀ·Q
// over the query tiles. Bound on an H100 SXM at B=8, H=16, S=2048, D=64,
// causal: four products of 34.4 GFLOP, 0.833 ms at 495/3 TFLOP/s, against
// six [B,S,H,D] fp32 tensors and two row statistics ≈ 202 MB, 0.060 ms:
// bound by operations (the same at B=8, H=4, D=256).
//
// One design takes every width, as K2's does. A CTA owns BN = 128 keys of
// one (b, h), 64 a consumer warpgroup, and CW = min(D, 128) columns of dK
// and dV; the grid's x axis is the CW chunks (fastest, so that the CTAs of
// a key block read the same chunks from L2 together), its y axis the key
// blocks of a head, longest first under the causal mask. One producer warp
// issues every TMA load. Every CTA walks its query tiles from the last one
// down, so that the key blocks of a head, which start together, read the
// same tile's chunks from L2 at the same time; walked upward, each from
// its own diagonal, they took 1.26× (D=64) and 1.41× (D=256) as long.
// - Operands. wgmma's .tf32 form reads both operands K-major. Sᵀ = K·Qᵀ
//   and dPᵀ = V·dOᵀ reduce over D: K and V (A) and Q and dO (B) are read in
//   their natural rows. dV += Pᵀ·dO and dK += dSᵀ·Q reduce over the query
//   axis: Pᵀ and dSᵀ are the register A operand, and with the query axis in
//   PERM order the accumulator pair of each k-step is the thread's A
//   fragment, as P is in K1 and dS in K2; the B operands are dOᵀ and Qᵀ,
//   queries contiguous.
// - A prologue (flash_f32_split_dkv_kernel, launched by the same C entry)
//   writes every operand's TF32 halves into scratch that the wrapper
//   allocates: Q_hi, Q_lo, dO_hi, dO_lo ([B, Sq, H, D]), K_hi, K_lo, V_hi,
//   V_lo ([B, Sk, H, D]) and Qᵀ_hi, Qᵀ_lo, dOᵀ_hi, dOᵀ_lo ([B, H, D, SqP],
//   queries in the order PERM within each group of 8, zeros past Sq):
//   twelve [B,S,H,D] tensors, 805 MB at both timed shapes, some 0.32 ms
//   of traffic at 3.35 TB/s. The CTA splits nothing but Pᵀ and dSᵀ:
//   splitting in shared memory, again for every tile, cost K2 26% of its
//   time at D=64 and 32% at D=256, its prologue 11% and 8%.
// - For each query tile of BM rows, Sᵀ and dPᵀ sum over D in KC = 32-column
//   chunks through a ring of two stages, each holding the chunk of K_hi,
//   K_lo, V_hi and V_lo (the CTA's 128 keys) and of Q_hi, Q_lo, dO_hi and
//   dO_lo (BM rows); then the tile's Qᵀ and dOᵀ halves over the CTA's CW
//   columns come through the same ring as one more item. Each chunk's
//   products go into accumulators of their own, small terms first, one
//   commit group, which once done releases the chunk's stage and adds into
//   the tile's Sᵀ and dPᵀ in fp32 on the CUDA cores (the tensor cores
//   truncate their sums at every k-step; K2's header). The warpgroup waits
//   on its own products a chunk; the other warpgroup's fill the tensor
//   cores meanwhile.
// - Then Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) (the scale rides in the
//   exponent) and dSᵀ on the accumulator, each split into TF32 halves, and
//   dV += Pᵀ·dO, dK += dSᵀ·Q (wgmma m64nCWk8, A from registers, three
//   passes a k-step), dK and dV in registers. lse and δ are read from device
//   memory, 0 past Sq.
// - Causal: query tiles wholly above the CTA's keys are never loaded; the
//   one a warpgroup may meet above its own 64 keys is masked whole, its
//   products issued all the same (a branch around them spilled 224 bytes
//   at CW=64 and cost 1.09× at D=64, 1.06× at D=256). Only tiles that
//   cross the diagonal or the ragged ends of Sq and Sk are masked. Rows
//   past Sq arrive from TMA as zeros, take lse 0 and δ 0 and are masked;
//   keys past Sk arrive as zeros, are masked and never stored. No atomics:
//   each CTA writes its own keys' dK and dV over its columns.
// - Why K and V stream: resident, their halves would take 128 KB a 128 keys
//   at D=64 and 256 KB at D=128, beside Q's and dO's. So they are read again
//   from L2 for every query tile: at the D=64 shape (BM = 64) a tile reads
//   128 KB of K and V, 32 KB of Q and dO and 64 KB of Qᵀ and dOᵀ, 8.9 GB in
//   all (K2 reads 5.6); at the d256 shape (BM = 32, two CTAs a key block)
//   24.5 GB. Two warpgroups on the same 64 keys on alternate query tiles
//   would read as much for the same work, and 64 keys a CTA twice as much.
// - Each of the D/CW CTAs of a key block computes the same Sᵀ and dPᵀ, so
//   the products do (D/CW + 1)/2 of the bound's operations (1.5 at D=256).
// Shared memory (plus 1 KB to align the base, and the mbarriers): two stages
//   of the larger of a chunk (K, V halves 4 × 16 KB + Q, dO halves 4 × BM ×
//   128 B) and the transposes (4 × CW × BM × 4 B): 2 × 96 KB at CW=64 (BM =
//   64), 2 × 80 KB at CW=128 (BM = 32).
// Registers (setmaxnreg: 24 a producer, 240 a consumer thread): dK and dV
//   CW/2 fp32 each, Sᵀ and dPᵀ BM/2 each, a chunk's products of each BM/2
//   more: 192 at both widths, which is why BM is 32 at CW=128 (BM = 32 at
//   CW=64 as well took 1.25× as long at D=64: twice the K and V reads).
//   Pᵀ's halves take the place of Sᵀ and the products; dSᵀ's those of Pᵀ,
//   once dV's products are done, and one descriptor register pair stands
//   for a stage's eight operands (with both halves live and a pair for each
//   operand, ptxas spilled 712 bytes at CW=64 and serialised the wgmma).
// Where the time goes (scripts/torch_f32_ablate.py on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit, B=8, S=2048, causal; D=64 with H=16, then
// D=256 with H=4): the prologue 15% and 10%; the lo passes 19% and 15%;
// the loads 8% and 25% (at D=256 the K and V halves of the key blocks in
// flight come to some 32 MB, read again every tile); the split of Pᵀ and
// dSᵀ 8% and 2%; the chunks' separate sums 2% and 1%.

// K3's scratch, in this order: Q_hi, Q_lo, dO_hi, dO_lo ([B, Sq, H, D]
// each), K_hi, K_lo, V_hi, V_lo ([B, Sk, H, D] each), Qᵀ_hi, Qᵀ_lo, dOᵀ_hi,
// dOᵀ_lo ([B, H, D, SqP] each): 4·B·H·D·(Sq + Sk + SqP) floats.
struct DkvHalves {
  float *qh, *ql, *dh, *dl;
  float *kh, *kl, *vh, *vl;
  float *qth, *qtl, *dth, *dtl;
};

// K3's prologue: rows [r0, r0 + PT) of both sequences, columns [d0, d0 +
// PT), split into the halves; Q and dO also transposed, queries in the
// order PERM within each group of 8, zeros past Sq.
__global__ void __launch_bounds__(256)
    flash_f32_split_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ dout,
                               const float* __restrict__ k,
                               const float* __restrict__ v, DkvHalves o,
                               int H, int Sq, int Sk, int SqP, int D) {
  __shared__ float tq[PT][PT + 1], td[PT][PT + 1];  // Q, dO [r0 + r][d0 + c]
  const int r0 = blockIdx.x * PT, d0 = blockIdx.y * PT;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const int row = r0 + r;
    float xq = 0.f, xd = 0.f;
    if (row < Sq) {
      const size_t i =
          ((static_cast<size_t>(b) * Sq + row) * H + h) * D + d0 + tx;
      xq = q[i];
      xd = dout[i];
      const Split a = split(xq), c = split(xd);
      o.qh[i] = __uint_as_float(a.hi);
      o.ql[i] = __uint_as_float(a.lo);
      o.dh[i] = __uint_as_float(c.hi);
      o.dl[i] = __uint_as_float(c.lo);
    }
    if (row < Sk) {
      const size_t i =
          ((static_cast<size_t>(b) * Sk + row) * H + h) * D + d0 + tx;
      const Split a = split(k[i]), c = split(v[i]);
      o.kh[i] = __uint_as_float(a.hi);
      o.kl[i] = __uint_as_float(a.lo);
      o.vh[i] = __uint_as_float(c.hi);
      o.vl[i] = __uint_as_float(c.lo);
    }
    tq[r][tx] = xq;
    td[r][tx] = xd;
  }
  __syncthreads();
  const int pos = r0 + tx;
  if (pos >= SqP) return;
  const int src = (tx & ~7) + perm8(tx & 7);
#pragma unroll
  for (int r = ty; r < PT; r += 8) {
    const Split a = split(tq[src][r]), c = split(td[src][r]);
    const size_t i =
        ((static_cast<size_t>(b) * H + h) * D + d0 + r) * SqP + pos;
    o.qth[i] = __uint_as_float(a.hi);
    o.qtl[i] = __uint_as_float(a.lo);
    o.dth[i] = __uint_as_float(c.hi);
    o.dtl[i] = __uint_as_float(c.lo);
  }
}

// The halves' places in the scratch and the tensor maps of K3's tiles over
// them: the row-major halves in boxes of `bm` (Q, dO) or `bn` (K, V) rows,
// the transposes in boxes of 32 queries by `cw` columns of D.
struct SplitDkv {
  int SqP;
  DkvHalves p;
  CUtensorMap tqh, tql, tdh, tdl, tkh, tkl, tvh, tvl, tqth, tqtl, tdth, tdtl;

  int make(void* scratch, int B, int H, int Sq, int Sk, int D, int bm,
           int bn, int cw) {
    SqP = (Sq + 7) / 8 * 8;
    const size_t nq = static_cast<size_t>(B) * Sq * H * D;
    const size_t nk = static_cast<size_t>(B) * Sk * H * D;
    const size_t nt = static_cast<size_t>(B) * H * D * SqP;
    p.qh = static_cast<float*>(scratch);
    p.ql = p.qh + nq;
    p.dh = p.ql + nq;
    p.dl = p.dh + nq;
    p.kh = p.dl + nq;
    p.kl = p.kh + nk;
    p.vh = p.kl + nk;
    p.vl = p.vh + nk;
    p.qth = p.vl + nk;
    p.qtl = p.qth + nt;
    p.dth = p.qtl + nt;
    p.dtl = p.dth + nt;
    int err = rows_map(&tqh, p.qh, B, Sq, H, D, bm);
    if (!err) err = rows_map(&tql, p.ql, B, Sq, H, D, bm);
    if (!err) err = rows_map(&tdh, p.dh, B, Sq, H, D, bm);
    if (!err) err = rows_map(&tdl, p.dl, B, Sq, H, D, bm);
    if (!err) err = rows_map(&tkh, p.kh, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tkl, p.kl, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tvh, p.vh, B, Sk, H, D, bn);
    if (!err) err = rows_map(&tvl, p.vl, B, Sk, H, D, bn);
    // Qᵀ and dOᵀ: coordinates (query, column, h, b)
    if (!err) err = make_map(&tqth, p.qth, {SqP, D, H, B}, {32, cw, 1, 1});
    if (!err) err = make_map(&tqtl, p.qtl, {SqP, D, H, B}, {32, cw, 1, 1});
    if (!err) err = make_map(&tdth, p.dth, {SqP, D, H, B}, {32, cw, 1, 1});
    if (!err) err = make_map(&tdtl, p.dtl, {SqP, D, H, B}, {32, cw, 1, 1});
    return err;
  }

  // The prologue: Q, dO, K and V split into the scratch.
  int launch(const void* q, const void* dout, const void* k, const void* v,
             int B, int H, int Sq, int Sk, int D, cudaStream_t st) const {
    const int rows = SqP > Sk ? SqP : Sk;
    flash_f32_split_dkv_kernel<<<dim3((rows + PT - 1) / PT, D / PT, B * H),
                                 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(dout),
        static_cast<const float*>(k), static_cast<const float*>(v), p, H, Sq,
        Sk, SqP, D);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CW>
struct DkvF32 {
  static constexpr int BN = 128;                 // keys of a CTA
  static constexpr int BM = CW == 64 ? 64 : 32;  // query rows of a tile
  static constexpr int KC = 32;                  // columns of D in a chunk
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BN * KC * 4;  // of K_hi, K_lo, V_hi, V_lo
  static constexpr int T_BYTES = BM * KC * 4;   // of Q_hi, Q_lo, dO_hi, dO_lo
  static constexpr int CHUNK_BYTES = 4 * KV_BYTES + 4 * T_BYTES;
  // each of Qᵀ_hi, Qᵀ_lo, dOᵀ_hi, dOᵀ_lo over the CTA's columns
  static constexpr int TR_BYTES = CW * BM * 4;
  static constexpr int STAGE_BYTES =
      CHUNK_BYTES > 4 * TR_BYTES ? CHUNK_BYTES : 4 * TR_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  // full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;
  static_assert(SMEM <= MAX_SMEM, "K3's ring exceeds shared memory");
};

template <int CW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_f32_kernel(const __grid_constant__ CUtensorMap tkh,
                         const __grid_constant__ CUtensorMap tkl,
                         const __grid_constant__ CUtensorMap tvh,
                         const __grid_constant__ CUtensorMap tvl,
                         const __grid_constant__ CUtensorMap tqh,
                         const __grid_constant__ CUtensorMap tql,
                         const __grid_constant__ CUtensorMap tdh,
                         const __grid_constant__ CUtensorMap tdl,
                         const __grid_constant__ CUtensorMap tqth,
                         const __grid_constant__ CUtensorMap tqtl,
                         const __grid_constant__ CUtensorMap tdth,
                         const __grid_constant__ CUtensorMap tdtl,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int q_off, int causal,
                         float scale) {
  using C = DkvF32<CW>;
  using Regs = RegSplit<24, 240>;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // an item of the ring: a chunk (K_hi, K_lo, V_hi, V_lo, then Q_hi, Q_lo,
  // dO_hi, dO_lo over KC columns) or a tile's transposes (Qᵀ_hi, Qᵀ_lo,
  // dOᵀ_hi, dOᵀ_lo over the CTA's columns)
  auto stage = [&](int s) {
    return reinterpret_cast<float*>(sm + s * C::STAGE_BYTES);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;

  const int c0 = blockIdx.x * CW;  // the CTA's columns of dK and dV
  const int k0 = blockIdx.y * BN;  // its first key
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int num_q = (Sq + BM - 1) / BM;
  // the first query tile whose last row q_off + (i+1)·BM − 1 reaches key k0
  const int i0 = causal ? min(num_q, max(0, k0 - q_off) / BM) : 0;
  const int nc = D / KC;  // chunks of D a tile's Sᵀ and dPᵀ sum over

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, in the order the
    // consumers take it: a tile's nc chunks, then its transposes
    Regs::producer();
    if (threadIdx.x == 0) {
      int it = 0;  // items issued
      for (int i = num_q - 1; i >= i0; --i) {
        const int q0 = i * BM;
        for (int c = 0; c <= nc; ++c, ++it) {
          const int s = it % ST;
          float* st = stage(s);
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          if (c < nc) {
            mbar_expect_tx(&full[s], C::CHUNK_BYTES);
            tma_load(st, &tkh, &full[s], c * KC, h, k0, b);
            tma_load(st + BN * KC, &tkl, &full[s], c * KC, h, k0, b);
            tma_load(st + 2 * BN * KC, &tvh, &full[s], c * KC, h, k0, b);
            tma_load(st + 3 * BN * KC, &tvl, &full[s], c * KC, h, k0, b);
            float* qs = st + 4 * BN * KC;
            tma_load(qs, &tqh, &full[s], c * KC, h, q0, b);
            tma_load(qs + BM * KC, &tql, &full[s], c * KC, h, q0, b);
            tma_load(qs + 2 * BM * KC, &tdh, &full[s], c * KC, h, q0, b);
            tma_load(qs + 3 * BM * KC, &tdl, &full[s], c * KC, h, q0, b);
          } else {
            mbar_expect_tx(&full[s], 4 * C::TR_BYTES);
#pragma unroll
            for (int p = 0; p < BM / 32; ++p) {
              float* tp = st + p * CW * 32;
              const int x = q0 + 32 * p;
              tma_load(tp, &tqth, &full[s], x, c0, h, b);
              tma_load(tp + CW * BM, &tqtl, &full[s], x, c0, h, b);
              tma_load(tp + 2 * CW * BM, &tdth, &full[s], x, c0, h, b);
              tma_load(tp + 3 * CW * BM, &tdtl, &full[s], x, c0, h, b);
            }
          }
        }
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 keys per warpgroup, Sᵀ, dPᵀ, dK and dV each
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + cw * 64;  // the warpgroup's first key
    const int key[2] = {kw + warp * 16 + g, kw + warp * 16 + g + 8};
    const float sl2 = scale * LOG2E;
    const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

    float dka[CW / 2], dva[CW / 2];
#pragma unroll
    for (int e = 0; e < CW / 2; ++e) dka[e] = dva[e] = 0.f;
    float st[BM / 2], dpt[BM / 2];  // Sᵀ (then Pᵀ), dPᵀ (then dSᵀ)
    float ps[BM / 2], pp[BM / 2];   // a chunk's products of each

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over one chunk's KC columns into ps and pp,
    // committed as one group: the small terms of the chunk first, then
    // hi·hi (a term the tensor cores add truncates the sum at the sum's own
    // magnitude, so the products near the sum's size come last and fewest).
    // Every operand's descriptor is the stage's plus a constant (16-byte
    // units), so that one register pair stands for all eight.
    auto issue_chunk = [&](const float* stg) {
      const uint64_t d0 = sw128_desc(stg, 16);
      const uint64_t kh = d0 + (cw * 64 * KC * 4 >> 4);  // the 64 keys
      constexpr uint32_t KV = C::KV_BYTES >> 4, T = C::T_BYTES >> 4;
      const uint64_t qh = d0 + 4 * KV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint32_t a = kmajor_step(64, kk), bk = kmajor_step(BM, kk);
        wgmma_ss_tf32<BM>(ps, kh + KV + a, qh + bk, kk > 0);
        wgmma_ss_tf32<BM>(ps, kh + a, qh + T + bk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk)
        wgmma_ss_tf32<BM>(ps, kh + kmajor_step(64, kk),
                          qh + kmajor_step(BM, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint32_t a = kmajor_step(64, kk), bk = kmajor_step(BM, kk);
        wgmma_ss_tf32<BM>(pp, kh + 3 * KV + a, qh + 2 * T + bk, kk > 0);
        wgmma_ss_tf32<BM>(pp, kh + 2 * KV + a, qh + 3 * T + bk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk)
        wgmma_ss_tf32<BM>(pp, kh + 2 * KV + kmajor_step(64, kk),
                          qh + 2 * T + kmajor_step(BM, kk), 1);
      wgmma_commit();
    };

    int it = 0;  // items taken
    for (int i = num_q - 1; i >= i0; --i) {
      const int q0 = i * BM;
      // Sᵀ and dPᵀ of the tile, summed over the nc chunks of D as they
      // arrive: each chunk's products, once done, release its stage and
      // add into st and dpt in fp32 (header)
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) st[e] = dpt[e] = 0.f;
      for (int c = 0; c < nc; ++c, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_chunk(stage(s));
        wgmma_wait<0>();
        fence_regs(ps);
        fence_regs(pp);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int e = 0; e < BM / 2; ++e) {
          st[e] += ps[e];
          dpt[e] += pp[e];
        }
      }
      const int s = it % ST;
      // Pᵀ in place of Sᵀ, dSᵀ in place of dPᵀ: element 4n + e is key
      // key[e >> 1], query q0 + 8n + 2t + (e & 1); the mask is a pass
      // behind a uniform branch, and masks the whole of a tile above the
      // warpgroup's keys (its products are issued all the same: a branch
      // around them cost registers and time)
      const bool masked = q0 + BM > Sq || kw + 64 > Sk ||
                          (causal && q_off + q0 < kw + 63);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qpos = q0 + 8 * n + 2 * t + u;
          const float lv = qpos < Sq ? lse[stat + qpos] * LOG2E : 0.f;
          const float dl = qpos < Sq ? delta[stat + qpos] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * n + 2 * r + u;
            float x = fmaf(st[e], sl2, -lv);
            if (masked && (qpos >= Sq || key[r] >= Sk ||
                           (causal && q_off + qpos < key[r])))
              x = NEG_INF;
            const float p = fast_exp2(x);
            st[e] = p;
            dpt[e] = p * (dpt[e] - dl) * scale;
          }
        }
      }
      // dV += Pᵀ·dO, then dK += dSᵀ·Q, over the CTA's columns (dOᵀ and Qᵀ
      // K-major), each A operand split as it is issued: the thread's
      // queries 2t, 2t+1 of k-step kk are logical columns t, t+4 (Qᵀ and
      // dOᵀ in PERM order). dV's products are done before dSᵀ is split,
      // so that the halves of only one of Pᵀ and dSᵀ are live at a time.
      uint32_t ah[BM / 8][4], al[BM / 8][4];
#pragma unroll
      for (int kk = 0; kk < BM / 8; ++kk)
        split_frag(ah[kk], al[kk], st[4 * kk], st[4 * kk + 2],
                   st[4 * kk + 1], st[4 * kk + 3]);
      mbar_wait(&full[s], (it / ST) & 1);
      const uint64_t qth = sw128_desc(stage(s), 16);
      constexpr uint32_t TR = C::TR_BYTES >> 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 8; ++kk) {
        const uint64_t dth = qth + 2 * TR + kmajor_step(CW, kk);
        wgmma_rs_tf32<CW>(dva, al[kk], dth);
        wgmma_rs_tf32<CW>(dva, ah[kk], dth + TR);
        wgmma_rs_tf32<CW>(dva, ah[kk], dth);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
#pragma unroll
      for (int kk = 0; kk < BM / 8; ++kk)
        split_frag(ah[kk], al[kk], dpt[4 * kk], dpt[4 * kk + 2],
                   dpt[4 * kk + 1], dpt[4 * kk + 3]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 8; ++kk) {
        const uint64_t bq = qth + kmajor_step(CW, kk);
        wgmma_rs_tf32<CW>(dka, al[kk], bq);
        wgmma_rs_tf32<CW>(dka, ah[kk], bq + TR);
        wgmma_rs_tf32<CW>(dka, ah[kk], bq);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      mbar_arrive(&empty[s]);
      ++it;
    }

    // dK and dV of the thread's keys, columns c0 + 8c + 2t, 2t + 1
    const size_t rs = static_cast<size_t>(H) * D;
    const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D + c0 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (key[half] >= Sk) continue;
      float* pk = dk + koff + key[half] * rs;
      float* pv = dv + koff + key[half] * rs;
#pragma unroll
      for (int c = 0; c < CW / 8; ++c) {
        *reinterpret_cast<float2*>(pk + 8 * c) =
            make_float2(dka[4 * c + 2 * half], dka[4 * c + 2 * half + 1]);
        *reinterpret_cast<float2*>(pv + 8 * c) =
            make_float2(dva[4 * c + 2 * half], dva[4 * c + 2 * half + 1]);
      }
    }
    trap_if_stalled();
  }
}

template <int CW>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* scratch, int B, int H, int Sq, int Sk, int D, int q_off,
               int causal, float scale, cudaStream_t st) {
  using C = DkvF32<CW>;
  SplitDkv x;
  int err = x.make(scratch, B, H, Sq, Sk, D, C::BM, C::BN, CW);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dkv_f32_kernel<CW>), C::SMEM);
  if (!err) err = x.launch(q, dout, k, v, B, H, Sq, Sk, D, st);
  if (err) return err;
  const dim3 grid(D / CW, (Sk + C::BN - 1) / C::BN, B * H);
  flash_dkv_f32_kernel<CW><<<grid, WS_THREADS, C::SMEM, st>>>(
      x.tkh, x.tkl, x.tvh, x.tvl, x.tqh, x.tql, x.tdh, x.tdl, x.tqth, x.tqtl,
      x.tdth, x.tdtl, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

inline bool takes(int B, int H, int Sq, int Sk, int D) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && (D == 64 || D == 128);
}

// The wide kernels' widths: every multiple of 128 above 128.
inline bool takes_wide(int B, int H, int Sq, int Sk, int D) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && D > 128 && D % 128 == 0;
}

}  // namespace f32
}  // namespace voda

// The C entries. Each returns 0, or the error of the tensor-map encoding, a
// kernel's set-up or its launch; 1 (cudaErrorInvalidValue) for a head_dim
// other than 64 or 128. K1 takes one more pointer than the bf16 forward,
// after lse: its scratch, 2·B·H·D·(Sk + SkP) floats; K3 after dv: its
// scratch, 4·B·H·D·(Sq + Sk + SqP) floats (SqP = Sq rounded up to 8); both
// the wrapper's `f32_scratch`, 16-byte aligned. K3 runs CW = D at D = 64 or
// 128.

extern "C" int voda_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* o, void* lse, void* scratch, int B,
                                  int H, int Sq, int Sk, int D, int q_off,
                                  int causal, float scale, void* stream) {
  using namespace voda::f32;
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_fwd<64>(q, k, v, o, lse, scratch, B, H, Sq, Sk,
                                  q_off, causal, scale, st)
                 : launch_fwd<128>(q, k, v, o, lse, scratch, B, H, Sq, Sk,
                                   q_off, causal, scale, st);
}

extern "C" int voda_flash_dkv_f32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  void* scratch, int B, int H, int Sq, int Sk,
                                  int D, int q_off, int causal, float scale,
                                  void* stream) {
  using namespace voda::f32;
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, scratch,
                                  B, H, Sq, Sk, D, q_off, causal, scale, st)
                 : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, scratch,
                                   B, H, Sq, Sk, D, q_off, causal, scale, st);
}

// Above 128 (every multiple of 128): the wide K1, and K3 at CW = 128, with
// the same arguments as the entries above, their scratch included; 1
// (cudaErrorInvalidValue) for any other width.
extern "C" int voda_flash_fwd_f32_wide(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       void* scratch, int B, int H, int Sq,
                                       int Sk, int D, int q_off, int causal,
                                       float scale, void* stream) {
  using namespace voda::f32;
  if (!takes_wide(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_wide<128>(q, k, v, o, lse, scratch, B, H, Sq, Sk, D,
                              q_off, causal, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int voda_flash_dkv_f32_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, void* scratch,
                                       int B, int H, int Sq, int Sk, int D,
                                       int q_off, int causal, float scale,
                                       void* stream) {
  using namespace voda::f32;
  if (!takes_wide(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, scratch, B, H, Sq,
                         Sk, D, q_off, causal, scale,
                         static_cast<cudaStream_t>(stream));
}

// K2 at D = 64 or 128 (CW = D) and, below, at every multiple of 128 above
// (CW = 128): the bf16 dQ's arguments, then its scratch, 2·B·H·D·(2·Sk +
// SkP) floats (the wrapper's `f32_scratch`), 16-byte aligned; 1
// (cudaErrorInvalidValue) for any other width.
extern "C" int voda_flash_dq_f32(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* scratch, int B, int H, int Sq, int Sk,
                                 int D, int q_off, int causal, float scale,
                                 void* stream) {
  using namespace voda::f32;
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(q, k, v, o, dout, lse, delta, dq, scratch, B,
                                 H, Sq, Sk, D, q_off, causal, scale, st)
                 : launch_dq<128>(q, k, v, o, dout, lse, delta, dq, scratch,
                                  B, H, Sq, Sk, D, q_off, causal, scale, st);
}

extern "C" int voda_flash_dq_f32_wide(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* scratch,
                                      int B, int H, int Sq, int Sk, int D,
                                      int q_off, int causal, float scale,
                                      void* stream) {
  using namespace voda::f32;
  if (!takes_wide(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, scratch, B, H, Sq,
                        Sk, D, q_off, causal, scale,
                        static_cast<cudaStream_t>(stream));
}
