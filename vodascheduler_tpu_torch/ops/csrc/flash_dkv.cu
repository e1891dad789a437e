// K3: flash-attention dK/dV for Hopper (sm_90a).
//
// Replaces `_dkv_kernel` in vodascheduler_tpu/ops/flash_attention.py (the
// second launch in `_bwd`): dK = Σᵢ dSᵀ·Q and dV = Σᵢ Pᵀ·dO, streaming the
// Q/dO tiles past each K/V tile, with Pᵀ = exp(K·Qᵀ·D^-½ − lse) and
// dSᵀ = Pᵀ∘(V·dOᵀ − δ)·D^-½.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): four products (K·Qᵀ,
// V·dOᵀ, Pᵀ·dO, dSᵀ·Q), halved under the causal mask: 137 GFLOP, 139 µs at
// B=8, H=16, S=2048, D=64, against ≈ 6·33.6 MB + 2·1 MB of bytes, 61 µs:
// compute-bound.
//
// Design. One CTA owns 128 keys of one (b, h): a producer warpgroup, whose
// warp 0 issues every load, and two consumer warpgroups of 64 keys each.
// - K and V arrive once by TMA and stay in shared memory (the wgmma A
//   operand of the two score products, so they cost no registers). Q and dO
//   tiles of BM query rows pass through a ring of STAGES stages; each stage
//   also carries that tile's lse and δ (written by the producer warp's
//   lanes, zero past Sq, which the column mask hides). Q + lse and dO + δ
//   have a "full" mbarrier each; the 256 consumer threads release a stage
//   on its "empty" mbarrier.
// - Per stage: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64nBMk16 from shared
//   memory (Q and dO K-major as B). Pᵀ = exp(Sᵀ·scale − lse) and
//   dSᵀ = Pᵀ∘(dPᵀ − δ)·scale are computed on the accumulators, cast to bf16
//   as the register A operand of dV += Pᵀ·dO and dK += dSᵀ·Q, whose B is the
//   same dO and Q stage read MN-major through the transpose bit. The scores
//   are computed transposed (keys on the rows) for this: Pᵀ and dSᵀ never
//   leave registers.
// - Causal: the loop starts at the first query tile whose last row reaches
//   the CTA's first key, only tiles that cross the diagonal or the ragged
//   end of Sq are masked, and the key tiles with the most work (the first)
//   are the first CTAs scheduled (the key tile is the grid's slowest axis;
//   the forward's order, tile fastest, measured no better here).
// - Registers: a consumer holds dK and dV (D/2 fp32 each), Sᵀ and dPᵀ
//   (BM/2 fp32 each) and the two bf16 A operands (BM/4 each); setmaxnreg
//   gives the consumers 232 of the registers the producer does not need.
//   No spill at D=64 or 128. While mbar_wait trapped inside its loop, ptxas
//   held the consumers to the launch's 168 registers: at D=128 it spilled
//   688 bytes, serialised the wgmma and took 1.95× as long
//   (scripts/torch_kernel_ab.py --shape d128 on an H100).
// - δ = rowsum(dO∘O) is read from `delta`, which the dQ kernel (flash_dq.cu)
//   wrote earlier on the same stream.
//
// No atomics: each CTA writes its own 128 rows of dK and dV, so both are
// deterministic.
//
// fp16 (voda_flash_dkv_f16). The same kernel on fp16 tensors, through
// wgmma's f16 form (the element type is a template parameter), with one
// change. `_dkv_kernel` rounds dS to the input dtype before dK = dSᵀ·Q
// (`ds.astype(q.dtype)`); in fp16 that flushes the dS of an unscaled loss
// (an output gradient of 1e-6 gives dS near 1e-8, below fp16's smallest
// normal, 6e-5), and wgmma takes both operands in one type, so dS cannot
// stay fp32 (as the CUDA-core kernels keep it) nor go to bf16 (Q would lose
// three bits). So each key row j of dSᵀ is rounded to fp16 under a
// power-of-two scale 2^e_j, K1's online rescaling applied to dK:
// - e_j is a running exponent, one for each of the thread's two key rows
//   (the same rows in dSᵀ and in dK's accumulator), E_MAX at the start;
// - each query tile takes the row's max |dSᵀ| over the quad that holds it
//   and the exponent that puts that max in [2^13, 2^14) (DS_TOP), far below
//   fp16's 65504; where that is below e_j, the row of dK's accumulator is
//   multiplied by 2^(new − old) (exact in fp32) and e_j lowered; a row with
//   no nonzero dS in the tile (masked) keeps its exponent;
// - 2^e_j rides in the factor that already multiplies dSᵀ by the softmax
//   scale, so the row is rounded to fp16 with 11 significant bits down to
//   2^-24 of its largest value (dS itself may be any fp32 magnitude), and
//   the products accumulate in fp32;
// - the epilogue stores dK's row times 2^-e_j.
// dV = Pᵀ·dO is unchanged: P ≤ 1 is rounded to fp16, as the TPU kernel
// rounds it. For bf16 none of this is compiled.

#include "hopper.cuh"

namespace voda {

template <int D>
struct Dkv {
  static constexpr int BN = 128;  // keys of a CTA
  // Query rows of a stage: 64 at D=64. At D=128 a consumer already holds
  // dK and dV in 128 fp32 registers, so the stage takes 32 rows, which
  // halves Sᵀ, dPᵀ and their bf16 copies (96 → 48 registers).
  static constexpr int BM = D == 64 ? 64 : 32;
  static constexpr int STAGES = D == 64 ? 3 : 4;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int T_BYTES = BM * D * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int STAT_OFF = DO_OFF + STAGES * T_BYTES;  // lse, δ
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BM * 4;
  // kv_full, q_full[STAGES], do_full[STAGES], empty[STAGES]; 1 KB of slack
  // to align the base to the 1024 bytes of the swizzle
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int D, typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int q_off,
                     int causal, float scale) {
  using C = Dkv<D>;
  // The producer warp also stages lse and δ, so it keeps 40 registers.
  using Regs = RegSplit<40, 232>;
  constexpr int BM = C::BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* ks = reinterpret_cast<T*>(sm);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  T* qs = reinterpret_cast<T*>(sm + C::Q_OFF);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  float* stat_s = reinterpret_cast<float*>(sm + C::STAT_OFF);  // [STAGES][2][BM]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + C::STAGES;
  uint64_t* empty = do_full + C::STAGES;

  const int h = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const int k0 = j * C::BN;
  const int num_q = (Sq + BM - 1) / BM;
  // first query tile whose last row q_off + (i+1)·BM − 1 reaches key k0
  const int i0 = causal ? max(0, k0 - q_off) / BM : 0;
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&q_full[s], 32);   // the producer warp's lanes
      mbar_init(&do_full[s], 32);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads, the lanes stage
    // the tile's lse and δ
    Regs::producer();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        tma_rows<D>(ks, &tk, kv_full, C::BN, h, k0, b);
        tma_rows<D>(vs, &tv, kv_full, C::BN, h, k0, b);
      }
      for (int i = i0; i < num_q; ++i) {
        const int it = i - i0, s = it % C::STAGES;
        const int q0 = i * BM;
        float* lse_s = stat_s + s * 2 * BM;
        float* del_s = lse_s + BM;
        // the loads go out before the wait; lse is kept in log2 units
        float lv[(BM + 31) / 32], dl[(BM + 31) / 32];
#pragma unroll
        for (int x = 0; x < (BM + 31) / 32; ++x) {
          const int r = q0 + lane + 32 * x;
          lv[x] = r < Sq ? lse[stat + r] * LOG2E : 0.f;
          dl[x] = r < Sq ? delta[stat + r] : 0.f;
        }
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
#pragma unroll
        for (int x = 0; x < (BM + 31) / 32; ++x) lse_s[lane + 32 * x] = lv[x];
        if (lane == 0) {
          mbar_expect_tx(&q_full[s], C::T_BYTES);
          tma_rows<D>(qs + s * BM * D, &tq, &q_full[s], BM, h, q0, b);
        } else {
          mbar_arrive(&q_full[s]);
        }
#pragma unroll
        for (int x = 0; x < (BM + 31) / 32; ++x) del_s[lane + 32 * x] = dl[x];
        if (lane == 0) {
          mbar_expect_tx(&do_full[s], C::T_BYTES);
          tma_rows<D>(dos + s * BM * D, &tdo, &do_full[s], BM, h, q0, b);
        } else {
          mbar_arrive(&do_full[s]);
        }
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: 64 keys per warpgroup
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + cw * 64;                  // the warpgroup's first key
    const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    const float sl2 = scale * LOG2E;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
    float st[BM / 2], dpt[BM / 2];
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
    // fp16: the exponent of each of the thread's key rows (header)
    constexpr bool SCALED = std::is_same<T, f16>::value;
    int ex[2] = {E_MAX, E_MAX};

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ of tile i, committed as one group. Both
    // barriers are waited for before the first wgmma: a wait between two
    // wgmma makes ptxas serialise them.
    auto issue_scores = [&](int i) {
      const int it = i - i0, s = it % C::STAGES;
      const uint32_t ph = (it / C::STAGES) & 1;
      mbar_wait(&q_full[s], ph);
      mbar_wait(&do_full[s], ph);
      const uint64_t kd = kmajor_desc(ks, cw * 64);
      const uint64_t qd = kmajor_desc(qs + s * BM * D, 0);
      const uint64_t vd = kmajor_desc(vs, cw * 64);
      const uint64_t dd = kmajor_desc(dos + s * BM * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM, T>(st, kd + kmajor_step(C::BN, kk),
                        qd + kmajor_step(BM, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM, T>(dpt, vd + kmajor_step(C::BN, kk),
                        dd + kmajor_step(BM, kk), kk > 0);
      wgmma_commit();
    };
    // Pᵀ and dSᵀ of tile i on the accumulators, then into A fragments; the
    // mask is a pass of its own behind a uniform branch
    auto p_ds = [&](int i) {
      fence_regs(st);
      fence_regs(dpt);
      const int s = (i - i0) % C::STAGES;
      const int q0 = i * BM;
      const float* lse_s = stat_s + s * 2 * BM;
      const float* del_s = lse_s + BM;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t);
        st[4 * c] = fmaf(st[4 * c], sl2, -ls.x);
        st[4 * c + 1] = fmaf(st[4 * c + 1], sl2, -ls.y);
        st[4 * c + 2] = fmaf(st[4 * c + 2], sl2, -ls.x);
        st[4 * c + 3] = fmaf(st[4 * c + 3], sl2, -ls.y);
      }
      if (q0 + BM > Sq || (causal && q_off + q0 < kw0 + 63)) {
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + 8 * c + 2 * t + (e & 1);
            if (qpos >= Sq || (causal && q_off + qpos < key[e >> 1]))
              st[4 * c + e] = NEG_INF;
          }
        }
      }
      float mx[2] = {0.f, 0.f};  // fp16: the rows' largest |dSᵀ| / scale
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(st[4 * c + e]);
          st[4 * c + e] = p;
          const float u = p * (dpt[4 * c + e] - ((e & 1) ? dl.y : dl.x));
          if constexpr (SCALED) {
            dpt[4 * c + e] = u;
            mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(u));
          } else {
            dpt[4 * c + e] = u * scale;
          }
        }
      }
      if constexpr (SCALED) {
        // each row's exponent, dK's row rescaled where it fell, then dSᵀ
        // times scale·2^e
        float f[2], fs[2];
        bool fell = false;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int en = ds_exponent(quad_max(mx[r]) * scale, ex[r]);
          f[r] = pow2i(max(en - ex[r], -126));
          fell |= en < ex[r];
          ex[r] = en;
          fs[r] = scale * pow2i(en);
        }
        if (__any_sync(0xffffffffu, fell)) {
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            dka[4 * c] *= f[0];
            dka[4 * c + 1] *= f[0];
            dka[4 * c + 2] *= f[1];
            dka[4 * c + 3] *= f[1];
          }
        }
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dpt[4 * c + e] *= fs[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        acc_to_a<BM / 2, T>(pa[kk], st, kk);
        acc_to_a<BM / 2, T>(dsa[kk], dpt, kk);
      }
    };
    // dV += Pᵀ·dO and dK += dSᵀ·Q of tile i, committed as one group
    auto issue_grads = [&](int i) {
      const int s = (i - i0) % C::STAGES;
      const uint64_t dd = mnmajor_desc(dos + s * BM * D, BM);
      const uint64_t qd = mnmajor_desc(qs + s * BM * D, BM);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        wgmma_rs<D, T>(dva, pa[kk], dd + mnmajor_step(kk));
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<D, T>(dka, dsa[kk], qd + mnmajor_step(kk));
      wgmma_commit();
    };

    // Both warpgroups walk the same tiles from i0 and the last tile is
    // peeled, so no wgmma sits behind a branch that ptxas cannot prove
    // warp-uniform (it serialises them, and spilled); a tile wholly above a
    // warpgroup's keys (at most the first one or two of warpgroup 1) is
    // masked to zero. The next tile's scores are issued after this tile's
    // dV and dK are in: with both in flight ptxas ran out of registers and
    // serialised the wgmma, 9% slower at D=64 (scripts/torch_kernel_ablate.py).
    mbar_wait(kv_full, 0);
    if (i0 < num_q) {
      issue_scores(i0);
      wgmma_wait<0>();
      for (int i = i0; i < num_q - 1; ++i) {
        p_ds(i);
        issue_grads(i);
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(&empty[(i - i0) % C::STAGES]);
        issue_scores(i + 1);
        wgmma_wait<0>();
      }
      p_ds(num_q - 1);
      issue_grads(num_q - 1);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[(num_q - 1 - i0) % C::STAGES]);
    }

    const int rs = H * D;
    const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D;
    if constexpr (SCALED)
      store_acc_rows<D>(dk + koff, dka, key[0], Sk, rs, pow2i(-ex[0]),
                        pow2i(-ex[1]), t);
    else
      store_acc_rows<D>(dk + koff, dka, key[0], Sk, rs, 1.f, 1.f, t);
    store_acc_rows<D>(dv + koff, dva, key[0], Sk, rs, 1.f, 1.f, t);
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Sq, int Sk, int q_off, int causal, float scale,
               cudaStream_t st) {
  using C = Dkv<D>;
  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dkv_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid(H, B, (Sk + C::BN - 1) / C::BN);
  flash_dkv_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a head_dim without an
// instantiation.
template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int Sq, int Sk, int D, int q_off, int causal, float scale,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                             q_off, causal, scale, st);
  if (D == 128)
    return launch_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                              q_off, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace voda

// bf16 and fp16 tensors, the same arguments.
extern "C" int voda_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int q_off,
                              int causal, float scale, void* stream) {
  return voda::dkv<voda::bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Sk, D, q_off, causal, scale, stream);
}

extern "C" int voda_flash_dkv_f16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int H, int Sq, int Sk, int D, int q_off,
                                  int causal, float scale, void* stream) {
  return voda::dkv<voda::f16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                              D, q_off, causal, scale, stream);
}
