// K1 for head widths above 128: the flash-attention forward for Hopper
// (sm_90a) at any D that is a multiple of 128.
//
// Replaces `_fwd_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_fwd`) where the JAX package takes D > 128 (a multiple of
// 128); flash_fwd.cu keeps D = 64 and 128. Streaming-softmax attention
// O = softmax(QKᵀ·scale)V with the causal mask offset by q_off, and
// lse = m + log l per row.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, and the same dense f16 rate,
// 3.35 TB/s): two products of 2·B·H·Sq·Sk·D FLOPs, halved under the causal
// mask: at B=8, H=4, S=2048, D=256, 68.7 GFLOP, 69 µs, against
// 4·8·4·2048·256·2 B + lse ≈ 134 MB, 40 µs: compute-bound (the same at
// B=8, H=2, D=512), in bf16 and in fp16 alike.
//
// Design: flash_fwd.cu's, widened (D = 256, 384, 512).
// - A CTA owns 128 query rows of one (b, h) and a chunk of O CW columns
//   wide: CW = 256 where D divides by 256, else 128 (the grid's y axis).
//   One producer warpgroup (one thread issues every TMA load) and two
//   consumer warpgroups of 64 rows.
// - Q arrives once by TMA and stays. K tiles of BN keys (80 at D=256, else
//   64) over the whole of D and V tiles of the same keys over the CTA's
//   chunk pass through a ring of STAGES stages. K and V have a "full" and
//   an "empty" mbarrier each, so the next K tile loads as soon as both
//   warpgroups' S products are done, before P·V is.
// - S = Q·Kᵀ is wgmma m64nBNk16 over all of D with both operands K-major in
//   shared memory; the online softmax (softmax_tile, hopper.cuh) runs on
//   the accumulator registers; P, cast to T, is the register A operand
//   of O += P·V (wgmma m64nCWk16), whose B = V is read MN-major through the
//   transpose bit. O stays in registers as wgmma accumulators. A warpgroup
//   issues S of tile j with P·V of tile j−1 and runs the softmax of tile j
//   under P·V; the two warpgroups take turns at issuing (Turns).
// - At D=256 one CTA covers the whole head, so each S is computed once. At
//   D/CW > 1 chunks, each CTA of a row block computes the same S: the
//   products do (D/CW + 1)/2 times the operations of the bound (1.5 at
//   D=512, 2 at D=384), the price of one softmax per row without atomics.
// - Causal: K/V tiles past the last row's diagonal are never loaded, only
//   tiles that cross the diagonal or the ragged end of Sk are masked, and
//   the query tiles are the grid's fastest axis, longest first.
// - Rows past Sq arrive from TMA as zeros and are never stored; keys past
//   Sk arrive as zeros and are masked to the finite NEG_INF.
//
// Shared memory, of the 227 KB (plus 1 KB to align the base to the
// swizzle's 1024 bytes, and the mbarriers):
//   D=256: Q 64 KB + 2 × (K 40 KB + V 40 KB) = 224 KB
//   D=384: Q 96 KB + 2 × (K 48 KB + V 16 KB) = 224 KB
//   D=512: Q 128 KB + 1 × (K 64 KB + V 32 KB) = 224 KB; with one stage the
//          next K tile loads under the softmax and P·V of this one, the
//          next V tile under the next S.
// Registers: setmaxnreg gives the producer 24 and each consumer thread 240
// (128·24 + 256·240 ≤ 384·168). A consumer holds O (CW/2 fp32: 128 at
// CW=256), S (BN/2 fp32: 40 at D=256) and P (BN/4 bf16x2, or f16x2: the
// f16 instantiation holds what the bf16 one does). ptxas spills nothing at
// D=256, 384 or 512 (nvcc -Xptxas -v, chip_smoke.py phase 2,
// which refuses a spill at D=256), once no trap sits in the waits
// (mbar_wait, hopper.cuh): with one, ptxas held the consumers to 168
// registers and spilled about 1.2 KB at D=256.
// Where the time goes at D=256 (scripts/torch_kernel_ablate.py --shape
// d256 on an H100, two runs of 3 rounds, about ±4% apart): the softmax
// 29%, the K/V loads 0-8%; without the turns the kernel is 2-10% slower.
// At D=512 the loads of the single stage take 23-24%; 32-key tiles, which
// make room for two stages, measured no faster.
//
// Above D=512 Q no longer fits beside one stage (Q alone is 160 KB at
// D=640, 256 KB at D=1024): those widths run flash_fwd_chunked_kernel
// below, which streams D.
//
// Nothing is carried between CTAs, so the result is deterministic.
//
// fp16 (voda_flash_fwd_f16_wide, every multiple of 128 from 256). The same
// kernels on fp16 tensors: the element type is a template parameter (bf16
// by default), as in flash_fwd.cu, and wgmma's f16 form takes the same
// fragments and descriptors at the same rate, so the shared memory (the
// sums above), the registers and the grid are those of bf16. P, which lies
// in [0, 1], is rounded to fp16 before P·V (finer than bf16 rounds it), O
// = acc / l is stored as fp16 (|O| ≤ max |V|), S, m, l and lse stay fp32:
// no scale is needed.

#include "hopper.cuh"

namespace voda {

template <int D>
struct FwdWide {
  static constexpr int CW = D % 256 == 0 ? 256 : 128;  // O's chunk of a CTA
  static constexpr int BM = 128;  // query rows of a CTA
  // keys of a K/V tile: 80 at D=256 (two stages of 80 fit beside Q, and
  // each k-step of S reads the A operand Q once for 80 keys, not 64: 3-15%
  // faster than 64 in three runs of scripts/torch_kernel_ablate.py on an
  // H100)
  static constexpr int BN = D == 256 ? 80 : 64;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int K_BYTES = BN * D * 2;
  static constexpr int V_BYTES = BN * CW * 2;
  // the stages that fit beside Q, at most two
  static constexpr int FIT = (MAX_SMEM - 1024 - Q_BYTES - 8 * 9) /
                             (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT < 2 ? FIT : 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES);
  static_assert(STAGES >= 1 && SMEM <= MAX_SMEM, "no stage fits beside Q");
};

template <int D, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          T* __restrict__ o, float* __restrict__ lse,
                          int H, int Sq, int Sk, int q_off, int causal,
                          float scale) {
  using C = FwdWide<D>;
  constexpr int CW = C::CW, BM = C::BM, BN = C::BN, ST = C::STAGES;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* ks = reinterpret_cast<T*>(sm + C::K_OFF);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int c0 = blockIdx.y * CW;            // the CTA's columns of O
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int q0 = i * BM;
  const int last_row = q_off + min(q0 + BM, Sq) - 1;
  const int nk_all = (Sk + BN - 1) / BN;
  const int n_k = causal ? min(nk_all, last_row / BN + 1) : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
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
    // ---- producer: one thread keeps the ring full
    Regs::producer();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_rows<D>(qs, &tq, q_full, BM, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;
        mbar_wait(&k_empty[s], ph);
        mbar_expect_tx(&k_full[s], C::K_BYTES);
        tma_rows<D>(ks + s * BN * D, &tk, &k_full[s], BN, h, j * BN, b);
        mbar_wait(&v_empty[s], ph);
        mbar_expect_tx(&v_full[s], C::V_BYTES);
        tma_rows<CW>(vs + s * BN * CW, &tv, &v_full[s], BN, h, j * BN, b, c0);
      }
      trap_if_stalled();
    }
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
    uint32_t pa[BN / 16][4];  // P as T, the A operand of P·V

    // S = Q·Kᵀ of tile j over all of D into sc, committed as one group
    auto issue_s = [&](int j) {
      const int s = j % ST;
      mbar_wait(&k_full[s], (j / ST) & 1);
      const uint64_t qd = kmajor_desc(qs, cw * 64);
      const uint64_t kd = kmajor_desc(ks + s * BN * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, T>(sc, qd + kmajor_step(BM, kk),
                        kd + kmajor_step(BN, kk), kk > 0);
      wgmma_commit();
    };
    // O += P·V of tile j over the CTA's chunk, committed as one group
    auto issue_pv = [&](int j) {
      const int s = j % ST;
      mbar_wait(&v_full[s], (j / ST) & 1);
      const uint64_t vd = mnmajor_desc(vs + s * BN * CW, BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<CW, T>(acc, pa[kk], vd + mnmajor_step(kk));
      wgmma_commit();
    };
    auto softmax = [&](int j) {
      const bool masked =
          (j + 1) * BN > Sk || (causal && j * BN + BN - 1 > wg_row0);
      softmax_tile<BN>(sc, m, l, corr, sl2, masked, j * BN, Sk, causal, row,
                       t);
    };
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        acc_to_a<BN / 2, T>(pa[kk], sc, kk);
    };

    const Turns<> turns{cw};
    mbar_wait(q_full, 0);
    if (n_k > 0) {
      turns.start_kernel();
      turns.begin();
      issue_s(0);
      turns.end(false);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&k_empty[0]);
      softmax(0);
      to_a();
      for (int j = 1; j < n_k; ++j) {
        turns.begin();
        issue_s(j);
        issue_pv(j - 1);
        turns.end(false);
        wgmma_wait<1>();  // S of tile j is in
        fence_regs(sc);
        mbar_arrive(&k_empty[j % ST]);
        softmax(j);
        wgmma_wait<0>();  // P·V of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(&v_empty[(j - 1) % ST]);
#pragma unroll
        for (int c = 0; c < CW / 8; ++c) {
          acc[4 * c] *= corr[0];
          acc[4 * c + 1] *= corr[0];
          acc[4 * c + 2] *= corr[1];
          acc[4 * c + 3] *= corr[1];
        }
        to_a();
      }
      turns.begin();
      issue_pv(n_k - 1);
      turns.end(true);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&v_empty[(n_k - 1) % ST]);
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
    store_acc_rows<CW>(o + (static_cast<size_t>(b) * Sq * H + h) * D + c0, acc,
                       q0 + r_loc, Sq, H * D, inv[0], inv[1], t);
    if (t == 0 && blockIdx.y == 0) {
      float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      if (q0 + r_loc < Sq) lb[q0 + r_loc] = lse_r[0];
      if (q0 + r_loc + 8 < Sq) lb[q0 + r_loc + 8] = lse_r[1];
    }
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int Sq, int Sk, int q_off,
                    int causal, float scale, cudaStream_t st) {
  using C = FwdWide<D>;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_fwd_wide_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, D / C::CW, B * H);
  flash_fwd_wide_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk,
      q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel at D = 256, 384 or 512 on tensors of T; 1
// (cudaErrorInvalidValue) at any other width.
template <typename T>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Sq, int Sk, int D, int q_off, int causal,
              float scale, cudaStream_t st) {
  if (D == 256)
    return launch_fwd_wide<256, T>(q, k, v, o, lse, B, H, Sq, Sk, q_off,
                                   causal, scale, st);
  if (D == 384)
    return launch_fwd_wide<384, T>(q, k, v, o, lse, B, H, Sq, Sk, q_off,
                                   causal, scale, st);
  if (D == 512)
    return launch_fwd_wide<512, T>(q, k, v, o, lse, B, H, Sq, Sk, q_off,
                                   causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------- widths above 512
//
// flash_fwd_chunked_kernel: K1 at any D that is a multiple of 128 (the
// entries send it D > 512). Bound at B=8, H=2, S=2048, D=640, causal: two
// products of 42.9 GFLOP, 86.9 µs at 989 TFLOP/s, against 168 MB, 50.1 µs
// at 3.35 TB/s: compute-bound, in bf16 and in fp16 alike.
//
// Design: flash_fwd_wide_kernel's, with the contraction of S = Q·Kᵀ over D
// cut into 128-column chunks, so that the shared memory no longer depends
// on D.
// - A CTA owns 128 query rows of one (b, h) and a chunk of O CW columns
//   wide: CW = 256 where D divides by 256, else 128 (the grid's y axis).
//   One producer warpgroup (one thread issues every TMA load) and two
//   consumer warpgroups of 64 rows.
// - For each tile of BN keys the producer streams, chunk by chunk of D,
//   a stage of (Q's 128 rows, K's BN rows) over the chunk's 128 columns
//   through a ring of STAGES stages, then the V tile of the same keys over
//   the CTA's chunk of O through a ring of two. Q is read again for every
//   key tile: from L2, where the D/CW CTAs of a row block find it.
// - S sums in registers over the D/128 chunk products (wgmma m64nBNk16, both
//   operands K-major, the accumulator kept from the second chunk on), one
//   commit group a chunk; once a chunk's products are done (wgmma_wait<1>
//   after the next chunk's issue) both warpgroups release its stage, the
//   last chunk's after the tile's S is in.
// - Then as in flash_fwd_wide_kernel: the online softmax on the
//   accumulators (softmax_tile), P cast to T as the register A operand of
//   O += P·V (m64nCWk16, V MN-major through the transpose bit), O in
//   registers; a warpgroup issues S of tile j, then P·V of tile j−1, and
//   runs the softmax of tile j under P·V.
// - No turns: both warpgroups read every chunk's stage, so a warpgroup that
//   held the turn through the D/128 chunks of its S would wait for a stage
//   that only the other warpgroup, waiting for the turn, can release, as
//   soon as D/128 exceeds STAGES.
// - Each CTA of a row block computes the same S: the products do
//   (D/CW + 1)/2 times the operations of the bound (3 at D=640, 4 at 896;
//   2 at 768, 2.5 at 1024), the price of one softmax per row without
//   atomics.
// - Causal: key tiles past the last row's diagonal are never loaded, only
//   tiles that cross the diagonal or the ragged end of Sk are masked, and
//   the query tiles are the grid's fastest axis, longest first. Rows past
//   Sq and keys past Sk arrive from TMA as zeros; the first are never
//   stored, the second masked to the finite NEG_INF.
//
// Shared memory (plus 1 KB to align the base, and the mbarriers):
//   CW=256, BN=64:  3 × (Q 32 KB + K 16 KB) + 2 × V 32 KB = 208 KB
//   CW=128, BN=128: 2 × (Q 32 KB + K 32 KB) + 2 × V 32 KB = 192 KB
// Registers (setmaxnreg: 24 for the producer, 240 a consumer thread): O
// CW/2 fp32, S BN/2 fp32, P BN/4 T x2: 176 at CW=256 (BN=64: BN=128 would
// take 224 and spill), 160 at CW=128, where 128 keys a tile halve the
// reads of Q for each key against 64 (64-key tiles measured 12% slower).
// Where the time goes at D=640 (scripts/torch_kernel_ablate.py --shape
// d640 on an H100): the loads 37%, the products past D's first chunk 12%,
// the softmax 3%; the kernel is bound by its reads from L2. Q held
// resident at D=640 (the only width above 512 where it fits beside a ring
// of K chunks, with 64-key tiles) measured 1.024× faster: not kept.

template <int CW>
struct FwdChunked {
  static constexpr int BM = 128;  // query rows of a CTA
  static constexpr int KC = 128;  // columns of D in a stage
  static constexpr int BN = CW == 256 ? 64 : 128;  // keys of a tile
  static constexpr int Q_BYTES = BM * KC * 2;
  static constexpr int K_BYTES = BN * KC * 2;
  static constexpr int V_BYTES = BN * CW * 2;
  static constexpr int V_STAGES = 2;
  // the stages of (Q, K) chunks that fit beside V's, at most four
  static constexpr int FIT = (MAX_SMEM - 1024 - V_STAGES * V_BYTES -
                              8 * 2 * (4 + V_STAGES)) /
                             (Q_BYTES + K_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int K_OFF = STAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * V_BYTES;
  // full[STAGES], empty[STAGES], v_full[V_STAGES], v_empty[V_STAGES]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * (STAGES + V_STAGES);
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "the ring does not fit");
};

template <int CW, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_chunked_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             T* __restrict__ o, float* __restrict__ lse,
                             int H, int Sq, int Sk, int D, int q_off,
                             int causal, float scale) {
  using C = FwdChunked<CW>;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC;
  constexpr int ST = C::STAGES, VST = C::V_STAGES;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* ks = reinterpret_cast<T*>(sm + C::K_OFF);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* v_full = empty + ST;
  uint64_t* v_empty = v_full + VST;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int c0 = blockIdx.y * CW;            // the CTA's columns of O
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
    for (int s = 0; s < VST; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps both rings full, in the order the
    // consumers take them: tile j's chunks, then its V tile
    Regs::producer();
    if (threadIdx.x == 0) {
      int it = 0;  // chunks issued
      for (int j = 0; j < n_k; ++j) {
        for (int c = 0; c < nc; ++c, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::Q_BYTES + C::K_BYTES);
          tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b, c * KC);
          tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, j * BN, b,
                       c * KC);
        }
        const int sv = j % VST;
        mbar_wait(&v_empty[sv], ((j / VST) & 1) ^ 1);
        mbar_expect_tx(&v_full[sv], C::V_BYTES);
        tma_rows<CW>(vs + sv * BN * CW, &tv, &v_full[sv], BN, h, j * BN, b,
                     c0);
      }
      trap_if_stalled();
    }
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
    float sacc[BN / 2];
    uint32_t pa[BN / 16][4];  // P as T, the A operand of P·V

    // The products of chunk `it` (of all the tiles' chunks) into sacc,
    // committed as one group; the first chunk of a tile (`first`, a
    // constant at each call) overwrites sacc.
    auto issue_chunk = [&](int it, bool first) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint64_t qd = kmajor_desc(qs + s * BM * KC, cw * 64);
      const uint64_t kd = kmajor_desc(ks + s * BN * KC, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_ss<BN, T>(sacc, qd + kmajor_step(BM, kk),
                        kd + kmajor_step(BN, kk), !first || kk > 0);
      wgmma_commit();
    };
    // S = Q·Kᵀ of tile j into sacc, summed over the nc chunks of D as they
    // arrive; each chunk's stage is released once the next chunk is issued
    // and its own products are done, the last chunk's by release_s. The
    // first chunk is issued apart, so that no branch stands around the
    // wait in the loop (one made ptxas serialise every wgmma).
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
    // O += P·V of tile j over the CTA's chunk, committed as one group
    auto issue_pv = [&](int j) {
      const int s = j % VST;
      mbar_wait(&v_full[s], (j / VST) & 1);
      const uint64_t vd = mnmajor_desc(vs + s * BN * CW, BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<CW, T>(acc, pa[kk], vd + mnmajor_step(kk));
      wgmma_commit();
    };
    auto softmax = [&](int j) {
      const bool masked =
          (j + 1) * BN > Sk || (causal && j * BN + BN - 1 > wg_row0);
      softmax_tile<BN>(sacc, m, l, corr, sl2, masked, j * BN, Sk, causal,
                       row, t);
    };
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        acc_to_a<BN / 2, T>(pa[kk], sacc, kk);
    };

    if (n_k > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      release_s(0);
      softmax(0);
      to_a();
      for (int j = 1; j < n_k; ++j) {
        issue_s(j);
        issue_pv(j - 1);
        wgmma_wait<1>();  // S of tile j is in
        fence_regs(sacc);
        release_s(j);
        softmax(j);
        wgmma_wait<0>();  // P·V of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(&v_empty[(j - 1) % VST]);
        // O's rows to the new max: element e is row half (e >> 1) & 1
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
        to_a();
      }
      issue_pv(n_k - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&v_empty[(n_k - 1) % VST]);
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
    store_acc_rows<CW>(o + (static_cast<size_t>(b) * Sq * H + h) * D + c0, acc,
                       q0 + r_loc, Sq, H * D, inv[0], inv[1], t);
    if (t == 0 && blockIdx.y == 0) {
      float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      if (q0 + r_loc < Sq) lb[q0 + r_loc] = lse_r[0];
      if (q0 + r_loc + 8 < Sq) lb[q0 + r_loc + 8] = lse_r[1];
    }
    trap_if_stalled();
  }
}

template <int CW, typename T>
int launch_fwd_chunked(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Sk, int D,
                       int q_off, int causal, float scale, cudaStream_t st) {
  using C = FwdChunked<CW>;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_fwd_chunked_kernel<CW, T>),
        C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, D / CW, B * H);
  flash_fwd_chunked_kernel<CW, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk, D,
      q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The chunked kernel on tensors of T at any D that is a multiple of 128,
// O's chunk 256 columns wide where D divides by 256.
template <typename T>
int fwd_chunked(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Sq, int Sk, int D, int q_off,
                int causal, float scale, cudaStream_t st) {
  if (D % 256 == 0)
    return launch_fwd_chunked<256, T>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off,
                                      causal, scale, st);
  return launch_fwd_chunked<128, T>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off,
                                    causal, scale, st);
}

}  // namespace voda

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
// D = 256, 384, 512: flash_fwd_wide_kernel; any multiple of 128 above 512:
// flash_fwd_chunked_kernel.
extern "C" int voda_flash_fwd_wide(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int Sq, int Sk, int D, int q_off,
                                   int causal, float scale, void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return fwd_chunked<bf16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                             scale, st);
  return fwd_wgmma<bf16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                         scale, st);
}

// fp16 tensors, the same arguments and the same kernels.
extern "C" int voda_flash_fwd_f16_wide(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int Sq, int Sk, int D,
                                       int q_off, int causal, float scale,
                                       void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return fwd_chunked<f16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                            scale, st);
  return fwd_wgmma<f16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                        scale, st);
}
