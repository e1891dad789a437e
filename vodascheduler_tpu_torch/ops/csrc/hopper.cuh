// Hopper building blocks of the flash-attention kernels (forward,
// flash_fwd.cu and flash_fwd_wide.cu; dQ, flash_dq.cu and flash_dq_wide.cu;
// dK/dV, flash_dkv.cu and flash_dkv_wide.cu): TMA tile loads into
// 128-byte-swizzled shared memory, mbarriers that guard a ring of stages,
// wgmma descriptors and the wgmma instructions the kernels issue,
// setmaxnreg, the named barriers of the consumer warpgroups' turns, the
// forwards' online softmax on a score accumulator, fp16's per-row scale of
// dS, the host-side tensor maps and shape check, and the scalar helpers
// (bf16 and fp16 packing, quad reductions).
//
// Layout: q, k, v, o, do, dq, dk, dv are bf16 [B, S, H, D] contiguous (the
// model layout, so no transpose runs around the kernels); lse and delta are
// fp32 [B, H, S]. Every kernel of this header also takes fp16: the helpers
// that touch an element take its type T (bf16 or f16) as a template
// parameter, bf16 by default. A 16-bit element of either type has the same
// shared layout, descriptors and wgmma fragments; only the conversions, the
// wgmma type string and the tensor map's data type differ.
//
// Shared layout of a tile. A [rows, D] 16-bit slice of a [B, S, H, D] tensor
// arrives by TMA as D/64 "parts", each [rows, 64] with 128-byte rows and
// the 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)).
// Part p starts at p * rows * 128 bytes; every part starts on 1024 bytes, so
// the swizzle's phase is that of the address and descriptors need no base
// offset. One tile serves wgmma in both majors:
//   K-major (the row axis is M or N, D is the reduction): 8-row groups
//     1024 bytes apart (SBO), k-step kk of 16 columns at part kk / 4, byte
//     offset (kk % 4) * 32 inside the row;
//   MN-major (the row axis is the reduction, D is N, transpose bit set):
//     k-step kk of 16 rows at byte kk * 2048, the second 64 columns of D
//     one part further (LBO = rows * 128 bytes).
//
// wgmma m64nNk16 fragments (thread 32w + 4g + t of a warpgroup):
// accumulator d[4*c + e] is row 16w + g + 8*(e >> 1), column
// 8c + 2t + (e & 1), the mma.sync C layout stacked along N. The register
// A fragment of k-step kk is {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]},
// {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]} packed to T x2, so a product's
// fp32 result feeds the next product from registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace voda {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernels

constexpr int WG_THREADS = 128;
// One producer warpgroup (its warp 0 issues every load) and two consumer
// warpgroups. 384 threads at one CTA per SM get 168 registers each at
// launch; setmaxnreg then moves them from the producer to the consumers, in
// splits that keep 128·producer + 256·consumer ≤ 384·168.
constexpr int WS_THREADS = 3 * WG_THREADS;
constexpr int LAUNCH_REGS = 168;
// Dynamic shared memory a block can take on an H100 (227 KB).
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as one T x2 register (T bf16 or f16), `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Reductions over the quad (the four threads t = 0..3 of a fragment row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One T x2 register (T bf16 or f16) as two fp32 values, the low half first.
template <typename T>
__device__ __forceinline__ float2 unpack2(const uint32_t& x);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(const uint32_t& x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
template <>
__device__ __forceinline__ float2 unpack2<f16>(const uint32_t& x) {
  return __half22float2(*reinterpret_cast<const __half2*>(&x));
}

// Σ a∘b over the 8 elements of T of two 16-byte chunks (the dQ kernels' δ).
template <typename T = bf16>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = unpack2<T>(x[i]);
    const float2 w = unpack2<T>(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity` to complete. A wait that lasts 4 s
// can only be a pipeline fault: it gives up and marks the card's copy of
// `voda_stalled`, and from then on every wait that has to spin gives up at
// once, so each CTA runs to its end, where trap_if_stalled turns the mark
// into a launch error instead of a hung card. A trap inside the wait would
// fail sooner, but with a trap on the consumers' path ptxas allocates their
// registers at the launch's 168 and not at setmaxnreg's count: the wide
// forward and dK/dV spilled some 1.2 KB at D=256 and serialised their
// wgmma, and K3 688 bytes at D=128.
__device__ unsigned int voda_stalled;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    volatile unsigned int* stalled = &voda_stalled;
    if (*stalled || global_ns() - t0 > 4000000000ull) {
      *stalled = 1;
      return;
    }
  }
}

// Ends each warpgroup's branch of a kernel that waits with mbar_wait.
__device__ __forceinline__ void trap_if_stalled() {
  if (*static_cast<volatile unsigned int*>(&voda_stalled)) __trap();
}

// ------------------------------------------------------- named barriers

// The two consumer warpgroups of the forward and of dQ take turns at
// issuing their products (named barriers 1 and 2, 256 threads each: one
// warpgroup waits, the other arrives), so the tensor cores run one
// warpgroup's products while the other warpgroup runs its elementwise work
// (the forward's softmax: at D=64, 64 exponentials a thread per tile at 16
// a clock on an SM, more than the products cost). Without the turns the
// forward is 6-8% slower and dQ at D=64 6-7% (scripts/torch_kernel_ablate.py
// on an H100).
// Warpgroup 0 goes first; every turn ends by handing over, except the last
// turn of warpgroup 1, so that each barrier sees as many arrivals as waits.
// Turns<false> does nothing, for a kernel that measures better without.
template <bool ON = true>
struct Turns {
  int cw;  // consumer warpgroup, 0 or 1
  __device__ __forceinline__ void start_kernel() const {
    if (ON && cw == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
  }
  __device__ __forceinline__ void begin() const {
    if (ON) asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");
  }
  __device__ __forceinline__ void end(bool last) const {
    if (ON && !(last && cw == 1))
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");
  }
};

// -------------------------------------------------------------------- TMA

// Rows [s0, s0 + rows) of head h, batch b, columns [c0, c0 + D), into the
// parts at `dst`, counted on `bar`; rows past S arrive as zeros. `map` is a
// tensor map of make_rows_map with the same `rows`.
template <int D, typename T>
__device__ __forceinline__ void tma_rows(T* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h,
                                         int s0, int b, int c0 = 0) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
            smem_u32(dst + p * rows * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0 + p * 64), "r"(h), "r"(s0), "r"(b)
        : "memory");
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled operand at `p` (8-row groups 1024
// bytes apart), `lbo` bytes to the next 64 columns of an MN-major operand.
// The base is passed through an empty asm so that the compiler derives each
// k-step's descriptor (base + a constant) where it is used, instead of
// hoisting one 64-bit register pair per k-step out of the loop.
template <typename T>
__device__ __forceinline__ uint64_t sw128_desc(const T* p, uint32_t lbo) {
  uint64_t d = static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
               (static_cast<uint64_t>(lbo >> 4) << 16) |
               (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
  asm volatile("" : "+l"(d));
  return d;
}

// K-major operand of a tile of `rows` rows, from row r0: the descriptor of
// k-step 0, and what k-step kk adds to it (16-byte units).
template <typename T>
__device__ __forceinline__ uint64_t kmajor_desc(const T* tile, int r0) {
  return sw128_desc(tile + r0 * 64, 16);
}
__host__ __device__ constexpr uint32_t kmajor_step(int rows, int kk) {
  return ((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4;
}

// MN-major operand of a tile of `rows` rows: the descriptor of k-step 0
// (rows 0..15), and what k-step kk (rows 16kk..16kk+15) adds to it.
template <typename T>
__device__ __forceinline__ uint64_t mnmajor_desc(const T* tile, int rows) {
  return sw128_desc(tile, rows * 128);
}
__host__ __device__ constexpr uint32_t mnmajor_step(int kk) {
  return (kk * 16 * 128) >> 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching `d` across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int PRODUCER_REGS, int CONSUMER_REGS>
struct RegSplit {
  static_assert(WG_THREADS * PRODUCER_REGS + 2 * WG_THREADS * CONSUMER_REGS <=
                    WS_THREADS * LAUNCH_REGS,
                "the split hands out more registers than the launch holds");
  __device__ __forceinline__ static void producer() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
  }
  __device__ __forceinline__ static void consumer() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  }
};

#define VODA_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VODA_F16(i) VODA_F4(i), VODA_F4(i + 4), VODA_F4(i + 8), VODA_F4(i + 12)
#define VODA_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define VODA_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define VODA_R40                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define VODA_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define VODA_R96                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define VODA_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"

// d[64 x N] (+)= A · B, A and B from shared memory (both K-major: the
// kernels' products with two shared operands are all of this form), both of
// type T.
template <int N, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

// d[64 x N] += A · B, A a register fragment, B an MN-major shared operand
// (transpose bit set), both of type T.
template <int N, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// The specialisations of both for operands of type T, which the instruction
// names TY ("bf16" or "f16"): the same fragments and descriptors, the same
// rate.
#define VODA_WGMMA(T, TY)                                                    \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<32, T>(                           \
      float(&d)[16], uint64_t a, uint64_t b, int accumulate) {               \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " VODA_R16 \
        ", %16, %17, p, 1, 1, 0, 0;\n}"                                      \
        : VODA_F16(0)                                                        \
        : "l"(a), "l"(b), "r"(accumulate));                                  \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<80, T>(                           \
      float(&d)[40], uint64_t a, uint64_t b, int accumulate) {               \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " " VODA_R40 \
        ", %40, %41, p, 1, 1, 0, 0;\n}"                                      \
        : VODA_F16(0), VODA_F16(16), VODA_F4(32), VODA_F4(36)                \
        : "l"(a), "l"(b), "r"(accumulate));                                  \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<64, T>(                           \
      float(&d)[32], uint64_t a, uint64_t b, int accumulate) {               \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " VODA_R32 \
        ", %32, %33, p, 1, 1, 0, 0;\n}"                                      \
        : VODA_F16(0), VODA_F16(16)                                          \
        : "l"(a), "l"(b), "r"(accumulate));                                  \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<128, T>(                          \
      float(&d)[64], uint64_t a, uint64_t b, int accumulate) {               \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
        VODA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}"                             \
        : VODA_F16(0), VODA_F16(16), VODA_F16(32), VODA_F16(48)              \
        : "l"(a), "l"(b), "r"(accumulate));                                  \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<64, T>(                           \
      float(&d)[32], const uint32_t(&a)[4], uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " VODA_R32 \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"                        \
        : VODA_F16(0), VODA_F16(16)                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<128, T>(                          \
      float(&d)[64], const uint32_t(&a)[4], uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
        VODA_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"               \
        : VODA_F16(0), VODA_F16(16), VODA_F16(32), VODA_F16(48)              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<192, T>(                          \
      float(&d)[96], const uint32_t(&a)[4], uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"                      \
        " wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " "        \
        VODA_R96 ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}"              \
        : VODA_F16(0), VODA_F16(16), VODA_F16(32), VODA_F16(48),             \
          VODA_F16(64), VODA_F16(80)                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<256, T>(                          \
      float(&d)[128], const uint32_t(&a)[4], uint64_t b) {                   \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"                      \
        " wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "        \
        VODA_R128 ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"         \
        : VODA_F16(0), VODA_F16(16), VODA_F16(32), VODA_F16(48),             \
          VODA_F16(64), VODA_F16(80), VODA_F16(96), VODA_F16(112)            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }

VODA_WGMMA(bf16, "bf16")
VODA_WGMMA(f16, "f16")
#undef VODA_WGMMA

#undef VODA_F4
#undef VODA_F16
#undef VODA_R16
#undef VODA_R32
#undef VODA_R40
#undef VODA_R64
#undef VODA_R96
#undef VODA_R128

// The A fragment of k-step kk from a 64 x N fp32 accumulator, cast to T.
template <int N, typename T = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
  a[0] = pack2<T>(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

// Stores a thread's two rows of a 64 x D fp32 accumulator as T rows of a
// [B, S, H, D] tensor, times a per-row factor; rows at or past `nrows` are
// dropped. `row` is the thread's first row, `base` points at (b, 0, h, 0).
template <int D, typename T>
__device__ __forceinline__ void store_acc_rows(T* base, const float (&d)[D / 2],
                                               int row, int nrows,
                                               int row_stride, float f0,
                                               float f1, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= nrows) continue;
    const float f = half ? f1 : f0;
    T* p = base + static_cast<size_t>(r) * row_stride + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(p + 8 * c) =
          pack2<T>(d[4 * c + 2 * half] * f, d[4 * c + 2 * half + 1] * f);
  }
}

// ---------------------------------------------------------------- softmax

// Online softmax of one S tile on its accumulator, in place: scores become
// P = exp2(S·scale·log2e − m), m the running row max in log2 units (the
// scale rides in the exponent's FMA), l takes the thread's part of the row
// sums, corr the factor that rescales what O has summed so far.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float sl2, bool masked, int col0,
                                             int Sk, int causal,
                                             const int (&row)[2], int t) {
  // The mask is a pass of its own behind a uniform branch: folded into the
  // loop below, it would be predicated onto every tile.
  if (masked) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * c + 2 * t + (e & 1);
        if (col >= Sk || (causal && row[e >> 1] < col)) sc[4 * c + e] = NEG_INF;
      }
    }
  }
  // Row max and row sum each run as four independent chains: a consumer
  // warp shares its SMSP with only one other, so a single chain of 32
  // dependent operations per row would leave the SMSP waiting on latency.
  float mx[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) mx[0][q] = mx[1][q] = NEG_INF;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][c % 4] = fmaxf(mx[e >> 1][c % 4], sc[4 * c + e]);
  }
  float mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row_max =
        fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mrow[r] = fmaxf(m[r], quad_max(row_max) * sl2);
    corr[r] = fast_exp2(m[r] - mrow[r]);
    m[r] = mrow[r];
  }
  float ls[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) ls[0][q] = ls[1][q] = 0.f;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * c + e], sl2, -mrow[e >> 1]));
      sc[4 * c + e] = p;
      ls[e >> 1][c % 4] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], corr[r], (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
}

// ------------------------------------------------ fp16's scale of dS

// fp16's dK/dV kernels (flash_dkv.cu, flash_dkv_wide.cu) round each key row
// j of dSᵀ to fp16 under a power of two 2^e_j, and fp16's dQ kernels
// (flash_dq.cu, flash_dq_wide.cu) each query row i of dS under 2^e_i: the
// scaled row max lies in [2^DS_TOP, 2^(DS_TOP+1)); exponents stay in
// [-E_MAX, E_MAX], so that 2^e and 2^-e are normal fp32 numbers.
constexpr int DS_TOP = 13;
constexpr int E_MAX = 100;

// 2^e for an integer e in [-126, 127], exactly.
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// A row's exponent after a tile whose largest |dS| in the row is m (0
// where the tile masks the whole row): the one that puts m in
// [2^DS_TOP, 2^(DS_TOP+1)) where that is below e, never below -E_MAX.
__device__ __forceinline__ int ds_exponent(float m, int e) {
  // DS_TOP minus the binade of m; a subnormal m reads as -127
  const int et = DS_TOP - (((__float_as_int(m) >> 23) & 0xff) - 127);
  return m > 0.f ? max(-E_MAX, min(e, et)) : e;
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over 16-bit [B, S, H, D] contiguous at `base` (bf16 unless
// `dtype` says otherwise) whose box is [rows, 64] of one (b, h): coordinates
// (column, h, s, b), 128-byte swizzle, zeros past S. Returns 0 or a nonzero
// CUresult.
inline int make_rows_map(
    CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, dtype, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The tensor map's data type of T.
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Raises the kernel's shared-memory limit to `smem` bytes and checks that
// it launches with the registers setmaxnreg hands out (a kernel that got
// fewer would wait forever in setmaxnreg.inc). Returns 0 or a cudaError_t.
inline int prepare_ws_kernel(const void* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs < LAUNCH_REGS)
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  return 0;
}

// What every entry of the wide sources (flash_{fwd,dq,dkv}_wide.cu) checks
// before a launch: D a multiple of 128, and B·H and D/128 within a grid
// axis.
inline bool shape_ok(int B, int H, int Sq, int Sk, int D) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && D > 0 && D % 128 == 0 &&
         (long)B * H <= 65535 && D / 128 <= 65535;
}

}  // namespace voda
