// K1, K2 and K3 for fp32 and fp16 inputs on the CUDA cores (sm_90a).
//
// Replace `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` in
// vodascheduler_tpu/ops/flash_attention.py for a model that computes in
// float32 or float16: the TPU kernels compute in q.dtype. The wgmma kernels
// beside this file take bf16, and fp16 at every width (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu: voda_flash_{fwd,dq,dkv}_f16 at 64 and 128;
// their wide twins, voda_flash_{fwd,dq,dkv}_f16_wide, above, whose kernels
// stream D above 512); fp32's forward, dQ and dK/dV run on the tensor cores
// in three TF32 passes at every width (flash_f32.cu:
// voda_flash_{fwd,dq,dkv}_f32, and _f32_wide above 128). So no route runs
// here: fp32's forward, dQ and dK/dV (voda_flash_{fwd,dq,dkv}_f32_simt) and
// fp16's (voda_flash_{fwd,dq,dkv}_f16_simt) lost their routes to the
// tensor-core kernels and keep their entries only to be timed against them.
// The kernels themselves take any multiple of their 64- or 128-column chunk. The arithmetic is
// the TPU kernels': every product takes its inputs in the input dtype and
// accumulates in fp32 (an fp16 product is exact in fp32), the softmax
// statistics are fp32, and P is rounded to the input dtype before the
// products it feeds (`p.astype(v.dtype)`). dS is not (the TPU kernels'
// `ds.astype(k.dtype)`): bf16 keeps fp32's exponent range, fp16 does not,
// and its smallest normal, 6e-5, flushes the dS of an unscaled loss (a
// 4-layer llama_350m-width model's last q_proj gradient moved 0.89 so, on
// an H100); for fp32 the rounding changes nothing.
//
// Design: a first kernel that is right, not yet a fast one.
// - A CTA of 256 threads owns a 64×64 tile of S (queries × keys); a thread
//   holds a 4×4 part of it, rows ty+16i and columns tx+16j (ty = tid/16,
//   tx = tid%16), so the 16 threads that share a row are 16 lanes of one
//   warp and reduce a row's max and sum by shuffles.
// - Q·Kᵀ (and dO·Vᵀ in the backward) runs over D in chunks of 32 columns,
//   each chunk staged in shared memory as fp32 (rows padded to 33 floats:
//   no bank conflicts).
// - The output side is cut along D: a CTA owns DC = min(D, 128) columns of
//   O, dQ or dK/dV (grid z), and a wider head recomputes S once per chunk,
//   as the wide bf16 kernels cut along D above 512. The accumulators stay in
//   registers (4 × DC/16 floats a thread and tensor).
// - Causal: key tiles past the last row's diagonal (K1, K2) and query tiles
//   before the first key's (K3) are skipped; the ragged ends of Sq and Sk
//   are masked.
// - lse and δ are fp32 [B, H, Sq], as for the bf16 kernels; K2 writes δ =
//   rowsum(dO∘O), K3 reads it.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace voda {
namespace simt {

constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // keys of a tile
constexpr int KC = 32;        // D columns of a chunk of a dot product
constexpr int KP = KC + 1;    // padded row of a chunk
constexpr int SP = BK + 1;    // padded row of a P or dS tile
constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: what a cast to the input dtype keeps.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Reduction over the 16 lanes that hold one row (one half of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r][c] = src row (row0 + r), column (col0 + c) as fp32, for r < rows
// and c < COLS; rows at or past `valid` read 0. `rs` is the row stride of
// the [B, S, H, D] layout (H·D), src already points at (b, 0, h, 0).
template <int COLS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, int row0, int rows,
                                          int valid, long rs, int col0) {
  for (int e = threadIdx.x; e < rows * COLS; e += NT) {
    const int r = e / COLS, c = e % COLS;
    const int row = row0 + r;
    dst[r * dst_stride + c] =
        row < valid ? to_f(src[(long)row * rs + col0 + c]) : 0.f;
  }
}

// s[i][j] += Σ_c A[ty+16i][c] · B[tx+16j][c] over one staged chunk.
__device__ __forceinline__ void chunk_dot(float (&s)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < KC; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * KP + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * KP + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += Σ_r L[r][ty+16i or row] · R[r][tx+16j]: the output side's
// product, with the left operand read as L[(ty+16i)*SP + r] when
// `left_rows` (P·V, dS·K) and as L[r*SP + ty+16i] otherwise (Pᵀ·dO, dSᵀ·Q).
template <int DC, bool left_rows>
__device__ __forceinline__ void out_product(float (&acc)[4][DC / 16],
                                            const float* L, const float* R,
                                            int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float a[4], b[DC / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = left_rows ? L[(ty + 16 * i) * SP + r] : L[r * SP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) b[j] = R[r * DC + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool masked(int row, int col, int Sk, int q_off,
                                       int causal) {
  return col >= Sk || (causal && q_off + row < col);
}

// ---------------------------------------------------------------------------
// K1: O and lse
// ---------------------------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Sk,
                          int D, int q_off, int causal, float scale) {
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Qc = smem;             // BQ × KP
  float* Kc = Qc + BQ * KP;     // BK × KP
  float* Ps = Kc + BK * KP;     // BQ × SP
  float* Vs = Ps + BQ * SP;     // BK × DC

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, d0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const T* qb = q + (long)b * Sq * rs + (long)h * D;
  const T* kb = k + (long)b * Sk * rs + (long)h * D;
  const T* vb = v + (long)b * Sk * rs + (long)h * D;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int kend = causal ? min(Sk, q_off + min(q0 + BQ, Sq)) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    float s[4][4] = {};
    for (int c0 = 0; c0 < D; c0 += KC) {
      __syncthreads();
      load_tile<KC>(Qc, KP, qb, q0, BQ, Sq, rs, c0);
      load_tile<KC>(Kc, KP, kb, k0, BK, Sk, rs, c0);
      __syncthreads();
      chunk_dot(s, Qc, Kc, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(row, k0 + tx + 16 * j, Sk, q_off, causal)
                      ? -INFINITY
                      : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    load_tile<DC>(Vs, DC, vb, k0, BK, Sk, rs, d0);
    __syncthreads();
    out_product<DC, true>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    T* orow = o + ((long)b * Sq + row) * rs + (long)h * D + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (blockIdx.z == 0 && tx == 0)
      lse[(long)bh * Sq + row] = m[i] + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

// ---------------------------------------------------------------------------
// The backward's shared part: S and dO·Vᵀ of one tile, then P and dS
// ---------------------------------------------------------------------------

// Stages Q/K and dO/V chunk by chunk and leaves, for the thread's 4×4 part of
// the (query, key) tile at (q0, k0): p (fp32) and ds = p∘(dp − δ)·scale.
template <typename T>
__device__ __forceinline__ void p_ds_tile(
    float (&p)[4][4], float (&ds)[4][4], float* Qc, float* Kc, float* Oc,
    float* Vc, const float* lse_s, const float* del_s, const T* qb,
    const T* kb, const T* vb, const T* dob, int q0, int k0, int Sq, int Sk,
    int D, long rs, int q_off, int causal, float scale, int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  for (int c0 = 0; c0 < D; c0 += KC) {
    __syncthreads();
    load_tile<KC>(Qc, KP, qb, q0, BQ, Sq, rs, c0);
    load_tile<KC>(Kc, KP, kb, k0, BK, Sk, rs, c0);
    load_tile<KC>(Oc, KP, dob, q0, BQ, Sq, rs, c0);
    load_tile<KC>(Vc, KP, vb, k0, BK, Sk, rs, c0);
    __syncthreads();
    chunk_dot(s, Qc, Kc, ty, tx);
    chunk_dot(dp, Oc, Vc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool off = q0 + r >= Sq ||
                       masked(q0 + r, k0 + tx + 16 * j, Sk, q_off, causal);
      p[i][j] = off ? 0.f : expf(s[i][j] * scale - lse_s[r]);
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[r]) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ and δ
// ---------------------------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq, int H,
                         int Sq, int Sk, int D, int q_off, int causal,
                         float scale) {
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Qc = smem;             // BQ × KP
  float* Kc = Qc + BQ * KP;     // BK × KP
  float* Oc = Kc + BK * KP;     // BQ × KP (dO)
  float* Vc = Oc + BQ * KP;     // BK × KP
  float* Ss = Vc + BK * KP;     // BQ × SP (dS)
  float* Ks = Ss + BQ * SP;     // BK × DC
  float* lse_s = Ks + BK * DC;  // BQ
  float* del_s = lse_s + BQ;    // BQ

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, d0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long head = (long)h * D;
  const T* qb = q + (long)b * Sq * rs + head;
  const T* kb = k + (long)b * Sk * rs + head;
  const T* vb = v + (long)b * Sk * rs + head;
  const T* ob = o + (long)b * Sq * rs + head;
  const T* dob = dout + (long)b * Sq * rs + head;

  {  // δ = rowsum(dO∘O) in fp32, four threads a row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq)
      for (int c = part; c < D; c += 4)
        acc += to_f(dob[(long)row * rs + c]) * to_f(ob[(long)row * rs + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      del_s[r] = acc;
      lse_s[r] = row < Sq ? lse[(long)bh * Sq + row] : 0.f;
      if (row < Sq && blockIdx.z == 0) delta[(long)bh * Sq + row] = acc;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const int kend = causal ? min(Sk, q_off + min(q0 + BQ, Sq)) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    float p[4][4], ds[4][4];
    p_ds_tile<T>(p, ds, Qc, Kc, Oc, Vc, lse_s, del_s, qb, kb, vb, dob, q0, k0,
                 Sq, Sk, D, rs, q_off, causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * SP + tx + 16 * j] = ds[i][j];
    load_tile<DC>(Ks, DC, kb, k0, BK, Sk, rs, d0);
    __syncthreads();
    out_product<DC, true>(acc, Ss, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* drow = dq + ((long)b * Sq + row) * rs + head + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) drow[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Sq, int Sk, int D,
                          int q_off, int causal, float scale) {
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Qc = smem;             // BQ × KP
  float* Kc = Qc + BQ * KP;     // BK × KP
  float* Oc = Kc + BK * KP;     // BQ × KP (dO)
  float* Vc = Oc + BQ * KP;     // BK × KP
  float* Ps = Vc + BK * KP;     // BQ × SP
  float* Ss = Ps + BQ * SP;     // BQ × SP (dS)
  float* Qs = Ss + BQ * SP;     // BQ × DC
  float* Os = Qs + BQ * DC;     // BQ × DC (dO)
  float* lse_s = Os + BQ * DC;  // BQ
  float* del_s = lse_s + BQ;    // BQ

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BK, bh = blockIdx.y, d0 = blockIdx.z * DC;
  const int b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const long head = (long)h * D;
  const T* qb = q + (long)b * Sq * rs + head;
  const T* kb = k + (long)b * Sk * rs + head;
  const T* vb = v + (long)b * Sk * rs + head;
  const T* dob = dout + (long)b * Sq * rs + head;

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  // Under the causal mask, query rows before k0 − q_off see no key of this
  // tile: start at the tile that holds that row.
  const int first = causal ? max(0, k0 - q_off) / BQ * BQ : 0;
  for (int q0 = first; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the last tile's readers of lse_s, del_s are done
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Sq ? lse[(long)bh * Sq + row] : 0.f;
      del_s[threadIdx.x] = row < Sq ? delta[(long)bh * Sq + row] : 0.f;
    }
    float p[4][4], ds[4][4];
    p_ds_tile<T>(p, ds, Qc, Kc, Oc, Vc, lse_s, del_s, qb, kb, vb, dob, q0, k0,
                 Sq, Sk, D, rs, q_off, causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = round_to<T>(p[i][j]);
        Ss[(ty + 16 * i) * SP + tx + 16 * j] = ds[i][j];
      }
    load_tile<DC>(Qs, DC, qb, q0, BQ, Sq, rs, d0);
    load_tile<DC>(Os, DC, dob, q0, BQ, Sq, rs, d0);
    __syncthreads();
    // dK += dSᵀ·Q, dV += Pᵀ·dO over the tile's 64 query rows.
    out_product<DC, false>(dka, Ss, Qs, ty, tx);
    out_product<DC, false>(dva, Ps, Os, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const long at = ((long)b * Sk + key) * rs + head + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[at + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t fwd_smem(int DC) {
  return sizeof(float) * (BQ * KP + BK * KP + BQ * SP + BK * DC);
}
constexpr size_t dq_smem(int DC) {
  return sizeof(float) * (2 * BQ * KP + 2 * BK * KP + BQ * SP + BK * DC + 2 * BQ);
}
constexpr size_t dkv_smem(int DC) {
  return sizeof(float) *
         (2 * BQ * KP + 2 * BK * KP + 2 * BQ * SP + 2 * BQ * DC + 2 * BQ);
}

// The grid: (tiles of the CTA's own axis, B·H, D / DC).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int tiles, int BH, int D, int DC,
           cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles, BH, D / DC);
  kernel<<<grid, NT, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// DC, the output columns a CTA owns: the whole head at 64, else 128.
inline int chunk(int D) { return D == 64 ? 64 : 128; }
inline bool takes(int B, int H, int Sq, int Sk, int D) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && D >= 64 && D % chunk(D) == 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
        int H, int Sq, int Sk, int D, int q_off, int causal, float scale,
        void* stream) {
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (Sq + BQ - 1) / BQ;
  auto args = [&](auto kernel, int DC) {
    return launch(kernel, fwd_smem(DC), tiles, B * H, D, DC, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<float*>(lse), H, Sq, Sk, D, q_off, causal,
                  scale);
  };
  return chunk(D) == 64 ? args(flash_fwd_simt_kernel<T, 64>, 64)
                        : args(flash_fwd_simt_kernel<T, 128>, 128);
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* delta, void* dq_, int B, int H,
       int Sq, int Sk, int D, int q_off, int causal, float scale,
       void* stream) {
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (Sq + BQ - 1) / BQ;
  auto args = [&](auto kernel, int DC) {
    return launch(kernel, dq_smem(DC), tiles, B * H, D, DC, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(dout),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<T*>(dq_), H, Sq, Sk, D, q_off, causal, scale);
  };
  return chunk(D) == 64 ? args(flash_dq_simt_kernel<T, 64>, 64)
                        : args(flash_dq_simt_kernel<T, 128>, 128);
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int Sq, int Sk, int D, int q_off, int causal, float scale,
        void* stream) {
  if (!takes(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (Sk + BK - 1) / BK;
  auto args = [&](auto kernel, int DC) {
    return launch(kernel, dkv_smem(DC), tiles, B * H, D, DC, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), H, Sq, Sk, D, q_off, causal, scale);
  };
  return chunk(D) == 64 ? args(flash_dkv_simt_kernel<T, 64>, 64)
                        : args(flash_dkv_simt_kernel<T, 128>, 128);
}

}  // namespace simt
}  // namespace voda

// The C interface, one entry a kernel and dtype, with the bf16 kernels'
// arguments: q k v o lse | B H Sq Sk D q_off causal scale stream, and so on.
// fp16's are named `_f16_simt`: fp16 takes the wgmma kernels at every width
// (flash_fwd.cu, flash_dq.cu, flash_dkv.cu, and their wide twins, whose
// kernels stream D above 512), and these are only timed against them.
// fp32's are named `_f32_simt`: fp32 takes flash_f32.cu's at every width,
// and these are only timed against them.
#define VODA_SIMT_ENTRIES(T, sfx)                                             \
  extern "C" int voda_flash_fwd_##sfx(                                        \
      const void* q, const void* k, const void* v, void* o, void* lse, int B, \
      int H, int Sq, int Sk, int D, int q_off, int causal, float scale,       \
      void* stream) {                                                         \
    return voda::simt::fwd<T>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off,       \
                              causal, scale, stream);                         \
  }                                                                           \
  extern "C" int voda_flash_dq_##sfx(                                         \
      const void* q, const void* k, const void* v, const void* o,            \
      const void* dout, const void* lse, void* delta, void* dq, int B, int H, \
      int Sq, int Sk, int D, int q_off, int causal, float scale,              \
      void* stream) {                                                         \
    return voda::simt::dq<T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, \
                             D, q_off, causal, scale, stream);                \
  }                                                                           \
  extern "C" int voda_flash_dkv_##sfx(                                        \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dk, void* dv, int B, int H,  \
      int Sq, int Sk, int D, int q_off, int causal, float scale,              \
      void* stream) {                                                         \
    return voda::simt::dkv<T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,   \
                              Sk, D, q_off, causal, scale, stream);           \
  }

VODA_SIMT_ENTRIES(float, f32_simt)
VODA_SIMT_ENTRIES(__half, f16_simt)
