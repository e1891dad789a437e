// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_fwd`): streaming-softmax attention O = softmax(QKᵀ·D^-½)V
// with the causal mask offset by q_off, emitting lse = m + log l per row.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): two products of
// 2·B·H·Sq·Sk·D FLOPs, halved under the causal mask. At B=8, H=16, S=2048,
// D=64 that is 68.7 GFLOP, 69 µs, against 4·8·16·2048·64·2 B + lse ≈ 135 MB,
// 40 µs: compute-bound, so the design is about keeping the tensor cores fed.
//
// Design. One CTA owns 128 query rows of one (b, h): a producer warpgroup,
// of which one thread issues every TMA load, and two consumer warpgroups of
// 64 rows each.
// - Q arrives once by TMA; K and V tiles of BN keys pass through a ring of
//   STAGES stages, each guarded by a "full" mbarrier per operand (K and V
//   apart, so QKᵀ starts before V lands) and one "empty" mbarrier that the
//   256 consumer threads arrive on when the stage's products are done. The
//   loads of the next tiles run under the products of this one.
// - S = Q·Kᵀ is wgmma m64nBNk16 with both operands K-major in shared
//   memory; the online softmax runs on the accumulator registers (a thread
//   holds parts of two rows, reduced across its quad); P, cast to bf16,
//   becomes the register A operand of O += P·V, whose B = V is read
//   MN-major from the same swizzled tile through the transpose bit. S and P
//   never leave registers.
// - Overlap: a warpgroup issues S of tile j and P·V of tile j−1 together
//   and runs the softmax of tile j while P·V runs; the two warpgroups take
//   turns at issuing (Turns in hopper.cuh), so one's softmax runs under the
//   other's products. At D=64 the softmax is what bounds the kernel: without
//   it the kernel takes 0.65 of its time, without its exponentials 0.90,
//   while loading K/V only once changes nothing
//   (scripts/torch_kernel_ablate.py on an H100).
// - Causal: K/V tiles past the last row's diagonal are never loaded
//   (q_off + last row ≥ j·BN), only tiles that cross the diagonal or the
//   ragged end of Sk are masked, and the query tiles are the grid's fastest
//   axis, reversed: the CTAs in flight together share a few heads' K/V in
//   L2 (with heads outermost a wave touches 66 MB of K/V at the main shape,
//   more than the 50 MB of L2; 5% slower, scripts/torch_kernel_ablate.py),
//   and the long tiles of each head start first.
// - Tiles: at D=64, 128 keys: a consumer holds S (64 fp32), P (32 bf16x2)
//   and O (32 fp32) registers, well under the 240 that setmaxnreg gives
//   it. At D=128, O alone is 64 registers and S of 128 keys made ptxas
//   spill and serialise the wgmma, so the K/V tiles are 64 keys. Three
//   stages: Q 16 KB + 3 × 32 KB at D=64, Q 32 KB + 3 × 32 KB at D=128, of
//   the 227 KB.
// - Rows past Sq arrive from TMA as zeros and are never stored; keys past
//   Sk arrive as zeros and are masked to the finite NEG_INF.
//
// Nothing is carried between CTAs, so the result is deterministic.
//
// fp16 (voda_flash_fwd_f16). The same kernel on fp16 tensors: wgmma's f16
// form (m64nNk16.f32.f16.f16) takes the same fragments and descriptors at
// the same rate, so the element type is a template parameter and nothing
// else changes. The arithmetic is `_fwd_kernel`'s in fp16: S, the running
// max and sum in fp32, P rounded to fp16 before P·V (P ≤ 1), O = acc / l
// stored as fp16 (|O| ≤ max |V|), lse fp32. None of it needs more range
// than fp16 has.

#include "hopper.cuh"

namespace voda {

template <int D>
struct Fwd {
  static constexpr int BM = 128;  // query rows of a CTA
  // keys of a K/V tile: at D=128 the consumer's O is 64 fp32 registers, and
  // 128 keys would add S (64) and P (32) on top, more than ptxas can keep
  // in flight without spilling; 64 keys halve S and P.
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; 1 KB of slack to
  // align the base to the 1024 bytes of the swizzle
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int D, typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Sq, int Sk, int q_off, int causal, float scale) {
  using C = Fwd<D>;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* ks = reinterpret_cast<T*>(sm + C::K_OFF);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* empty = v_full + C::STAGES;

  const int h = blockIdx.y, b = blockIdx.z;
  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int q0 = i * C::BM;
  const int last_row = q_off + min(q0 + C::BM, Sq) - 1;
  const int nk_all = (Sk + C::BN - 1) / C::BN;
  const int n_k = causal ? min(nk_all, last_row / C::BN + 1) : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
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
      tma_rows<D>(qs, &tq, q_full, C::BM, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_rows<D>(ks + s * C::BN * D, &tk, &k_full[s], C::BN, h, j * C::BN, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_rows<D>(vs + s * C::BN * D, &tv, &v_full[s], C::BN, h, j * C::BN, b);
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 query rows per warpgroup. While the tensor cores
    // run P·V of tile j−1, the warpgroup runs the softmax of tile j, whose
    // S = Q·Kᵀ was issued just before.
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
    float sc[C::BN / 2];
    uint32_t pa[C::BN / 16][4];  // P as T, the A operand of P·V

    // S = Q·Kᵀ of tile j into sc, committed as one group
    auto issue_s = [&](int j) {
      const int s = j % C::STAGES;
      mbar_wait(&k_full[s], (j / C::STAGES) & 1);
      const uint64_t qd = kmajor_desc(qs, cw * 64);
      const uint64_t kd = kmajor_desc(ks + s * C::BN * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BN, T>(sc, qd + kmajor_step(C::BM, kk),
                        kd + kmajor_step(C::BN, kk), kk > 0);
      wgmma_commit();
    };
    // O += P·V of tile j, committed as one group
    auto issue_pv = [&](int j) {
      const int s = j % C::STAGES;
      mbar_wait(&v_full[s], (j / C::STAGES) & 1);
      const uint64_t vd = mnmajor_desc(vs + s * C::BN * D, C::BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        wgmma_rs<D, T>(acc, pa[kk], vd + mnmajor_step(kk));
      wgmma_commit();
    };
    auto softmax = [&](int j) {
      const bool masked = (j + 1) * C::BN > Sk ||
                          (causal && j * C::BN + C::BN - 1 > wg_row0);
      softmax_tile<C::BN>(sc, m, l, corr, sl2, masked, j * C::BN, Sk, causal,
                          row, t);
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
      softmax(0);
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        acc_to_a<C::BN / 2, T>(pa[kk], sc, kk);
      for (int j = 1; j < n_k; ++j) {
        turns.begin();
        issue_s(j);
        issue_pv(j - 1);
        turns.end(false);
        wgmma_wait<1>();   // S of tile j is in
        fence_regs(sc);
        softmax(j);
        wgmma_wait<0>();   // P·V of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(&empty[(j - 1) % C::STAGES]);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c] *= corr[0];
          acc[4 * c + 1] *= corr[0];
          acc[4 * c + 2] *= corr[1];
          acc[4 * c + 3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          acc_to_a<C::BN / 2, T>(pa[kk], sc, kk);
      }
      turns.begin();
      issue_pv(n_k - 1);
      turns.end(true);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(n_k - 1) % C::STAGES]);
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
    const int rs = H * D;
    store_acc_rows<D>(o + (static_cast<size_t>(b) * Sq * H + h) * D, acc,
                      q0 + r_loc, Sq, rs, inv[0], inv[1], t);
    if (t == 0) {
      float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      if (q0 + r_loc < Sq) lb[q0 + r_loc] = lse_r[0];
      if (q0 + r_loc + 8 < Sq) lb[q0 + r_loc + 8] = lse_r[1];
    }
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Sq, int Sk, int q_off, int causal,
               float scale, cudaStream_t st) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, tma_type<T>());
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, tma_type<T>());
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, tma_type<T>());
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_fwd_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, H, B);
  flash_fwd_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk,
      q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a head_dim without an
// instantiation.
template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
        int H, int Sq, int Sk, int D, int q_off, int causal, float scale,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64, T>(q, k, v, o, lse, B, H, Sq, Sk, q_off, causal,
                             scale, st);
  if (D == 128)
    return launch_fwd<128, T>(q, k, v, o, lse, B, H, Sq, Sk, q_off, causal,
                              scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace voda

// bf16 and fp16 tensors, the same arguments.
extern "C" int voda_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Sq, int Sk,
                              int D, int q_off, int causal, float scale,
                              void* stream) {
  return voda::fwd<voda::bf16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                               scale, stream);
}

extern "C" int voda_flash_fwd_f16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Sq,
                                  int Sk, int D, int q_off, int causal,
                                  float scale, void* stream) {
  return voda::fwd<voda::f16>(q, k, v, o, lse, B, H, Sq, Sk, D, q_off, causal,
                              scale, stream);
}
