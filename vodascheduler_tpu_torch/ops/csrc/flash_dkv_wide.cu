// K3 for head widths above 128: dK and dV of flash attention for Hopper
// (sm_90a) at any D that is a multiple of 128.
//
// Replaces `_dkv_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_bwd`) where the JAX package takes D > 128; flash_dkv.cu
// keeps D = 64 and 128. With Pᵀ = exp(K·Qᵀ·scale − lse) and dSᵀ =
// Pᵀ∘(V·dOᵀ − δ)·scale recomputed from the forward's lse and the dQ
// kernel's δ: dK = dSᵀ·Q and dV = Pᵀ·dO.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, and the same dense f16 rate,
// 3.35 TB/s): four products of 2·B·H·Sq·Sk·D FLOPs (Sᵀ, dPᵀ, Pᵀ·dO,
// dSᵀ·Q), halved under the causal mask: at B=8, H=4, S=2048, D=256, 137
// GFLOP, 139 µs, against six [B,S,H,D] 16-bit tensors and two row
// statistics ≈ 201 MB, 60 µs: compute-bound (the same at B=8, H=2, D=512),
// in bf16 and in fp16 alike.
//
// Design (D = 256, 384, 512):
// - A CTA owns 64 keys of one (b, h) and a chunk of dK and dV CW columns
//   wide: CW = 256 where D divides by 256, else 128 (the grid's y axis).
//   One producer warpgroup (warp 0: lane 0 issues the TMA loads, the lanes
//   stage each tile's lse and δ) and two consumer warpgroups.
// - K and V arrive once by TMA and stay. Q and dO tiles of BM query rows
//   over all of D pass through a ring of STAGES stages, with a "full"
//   mbarrier each and one "empty" that the 256 consumer threads arrive on.
// - The consumers split the work of a tile by operand, and the chunk by
//   halves. Warpgroup 0 computes Sᵀ = K·Qᵀ and warpgroup 1 dPᵀ = V·dOᵀ, each
//   once, over all of D (wgmma m64nBMk16, both operands K-major in shared
//   memory). Warpgroup 0 turns Sᵀ into Pᵀ = exp(Sᵀ·scale − lse) on its
//   accumulators and hands Pᵀ to warpgroup 1 as fp32 through shared memory
//   (named barrier 3); warpgroup 1 computes dSᵀ = Pᵀ∘(dPᵀ − δ)·scale and
//   hands it back as A fragments of T (named barrier 4). Both layouts are
//   the accumulator's own, thread by thread, so the exchange is a
//   conflict-free 16-byte store and load a thread. Then each warpgroup runs
//   dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half]
//   (wgmma m64n(CW/2)k16, A from registers, B the same Q and dO stage read
//   MN-major through the transpose bit), dK and dV staying in registers.
// - At D=256 one CTA covers the whole head, so each Sᵀ and dPᵀ is computed
//   once. With D/CW > 1 chunks the CTAs of a key block each compute them:
//   the products do (D/CW + 1)/2 times the operations of the bound (1.5 at
//   D=512, 2 at D=384).
// - Causal: the loop starts at the first query tile whose last row reaches
//   the CTA's first key; only tiles that cross the diagonal or the ragged
//   end of Sq are masked (Pᵀ = 0 there, so dSᵀ = 0). The key tiles are the
//   grid's fastest axis, so the CTAs in flight share a few heads' Q and dO
//   in L2. A key block that no query sees writes zeros.
// - Keys past Sk arrive from TMA as zeros; their rows are never stored.
//
// Shared memory, of the 227 KB (plus 1 KB to align the base to the
// swizzle's 1024 bytes, and the mbarriers), bf16 (fp16 adds the exponents'
// 1 KB, below):
//   D=256, BM=64: K, V 64 KB + 2 × (Q, dO 64 KB + lse, δ) + Pᵀ 16 KB +
//                 dSᵀ 8 KB = 217 KB (fp16: 218 KB; 219.05 KiB launched)
//   D=384, BM=32: K, V 96 KB + 2 × (Q, dO 48 KB) + 12 KB = 204 KB (fp16:
//                 205 KB)
//   D=512, BM=32: K, V 128 KB + 1 × (Q, dO 64 KB) + 12 KB = 204 KB (fp16:
//                 205 KB); with one stage a tile's loads wait for the last
//                 tile's products. The exponents' slot changes no width's
//                 BM or stages.
// Registers: setmaxnreg gives the producer 40 and each consumer thread 232.
// A consumer holds dK and dV for its half (CW/4 fp32 each: 64 at CW=256),
// Sᵀ or dPᵀ (BM/2 fp32) and the two A operands of T (BM/4 each); fp16 adds
// the two exponents of the thread's key rows and, for the tile's scale,
// a few registers more. ptxas
// spills nothing at D=256, 384 or 512 (chip_smoke.py phase 2 refuses a
// spill at D=256), once no trap sits in the waits, as in flash_fwd_wide.cu.
// Where the time goes (scripts/torch_kernel_ablate.py on an H100, two
// runs of 3 rounds, about ±4% apart): at D=256 the warpgroups' waits on
// each other's Pᵀ and dSᵀ take 5-19%, the exponentials no more than the
// spread; at D=512 the loads of the single stage 22-24%, the waits 5-10%.
//
// Above D=512 K and V no longer fit beside a stage: both types run
// flash_dkv_chunked_kernel there (below), which streams D.
//
// δ = rowsum(dO∘O) is read from `delta`, which the dQ kernel wrote earlier
// on the same stream. No atomics: each CTA writes its own rows and columns
// of dK and dV, so both are deterministic.
//
// fp16 (voda_flash_dkv_f16_wide, D = 256, 384, 512). The same kernel on
// fp16 tensors, the element type a template parameter (bf16 by default),
// with flash_dkv.cu's per-key-row scale of dSᵀ carried over to this split
// of the work. wgmma takes both operands in one type, so dSᵀ is rounded to
// fp16, where an unscaled loss's dS (near 1e-8 for an output gradient of
// 1e-6) would flush below fp16's smallest normal, 6e-5. So:
// - Warpgroup 1, which forms dSᵀ, keeps a running exponent e_j for each of
//   its thread's two key rows (E_MAX at the start). For each query tile it
//   takes the row's largest |Pᵀ∘(dPᵀ − δ)| over the quad that holds the
//   row, times scale, and lowers e_j to the exponent that puts it in
//   [2^13, 2^14) where that is lower (ds_exponent, hopper.cuh; never below
//   −E_MAX; a row the tile masks keeps e_j). 2^e_j rides in the factor that
//   already applies scale, and the row is packed to fp16 A fragments.
// - Both warpgroups accumulate dK over the same 64 key rows, each in its
//   half of the columns, and thread tid of warpgroup 0 holds the same two
//   key rows as thread tid of warpgroup 1 (the m64 accumulator layout). So
//   warpgroup 1 writes its thread's two new exponents (8 bytes) beside the
//   dSᵀ fragments in the exchange, behind the same named barrier 4, and
//   warpgroup 0 reads them with the fragments: both keep the same e_j.
// - Each warpgroup multiplies its half of dK's row by 2^(new − old) where
//   the exponent fell (exact in fp32; behind a warp vote, so a tile with no
//   change costs one vote), after the last tile's dV and dK products have
//   completed and before this tile's are issued.
// - The epilogue stores dK's row times 2^−e_j in both warpgroups. dV is
//   unscaled: Pᵀ lies in [0, 1] and is rounded to fp16 as it stands.
// At D = 384 and 512 the CTAs of a key block (one a chunk of dK's columns)
// each compute the same Sᵀ, dPᵀ and dSᵀ tiles over all of D, in the same
// order, so each derives the same e_j for a row: dK's columns agree across
// CTAs with nothing exchanged between them. For bf16 none of this is
// compiled (`if constexpr`), and its shared layout is the parent's.

#include "hopper.cuh"

namespace voda {

template <int D, typename T = bf16>
struct DkvWide {
  // fp16: dSᵀ under a per-key-row scale, whose exponents the exchange
  // carries too (header)
  static constexpr bool SCALED = std::is_same<T, f16>::value;
  static constexpr int XE_BYTES = SCALED ? 8 * WG_THREADS : 0;
  static constexpr int CW = D % 256 == 0 ? 256 : 128;  // dK/dV chunk of a CTA
  static constexpr int HW = CW / 2;  // a consumer warpgroup's half of it
  static constexpr int BN = 64;      // keys of a CTA
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int ROOM = MAX_SMEM - 1024 - 2 * KV_BYTES - 8 * 8;
  // a stage of `bm` query rows: Q, dO, lse, δ
  static constexpr int stage_bytes(int bm) { return 4 * bm * D + 8 * bm; }
  // the exchange: Pᵀ as fp32 and dSᵀ as A fragments of T (and, for fp16,
  // the exponents of dSᵀ's rows)
  static constexpr int xchg_bytes(int bm) {
    return 256 * bm + 128 * bm + XE_BYTES;
  }
  static constexpr int fit(int bm) {
    return (ROOM - xchg_bytes(bm)) / stage_bytes(bm);
  }
  // query rows of a stage: 64 where two stages fit, else 32
  static constexpr int BM = fit(64) >= 2 ? 64 : 32;
  static constexpr int STAGES = fit(BM) < 2 ? fit(BM) : 2;
  static constexpr int T_BYTES = BM * D * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int STAT_OFF = DO_OFF + STAGES * T_BYTES;  // lse, δ
  static constexpr int XP_OFF = STAT_OFF + STAGES * 2 * BM * 4;
  static constexpr int XDS_OFF = XP_OFF + 256 * BM;
  static constexpr int XE_OFF = XDS_OFF + 128 * BM;
  static constexpr int BAR_OFF = XE_OFF + XE_BYTES;
  // kv_full, q_full[STAGES], do_full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
  static_assert(STAGES >= 1 && SMEM <= MAX_SMEM, "no stage fits beside K, V");
};

template <int D, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Sq, int Sk, int q_off, int causal,
                          float scale) {
  using C = DkvWide<D, T>;
  constexpr bool SCALED = C::SCALED;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, HW = C::HW;
  // The producer warp also stages lse and δ, so it keeps 40 registers.
  using Regs = RegSplit<40, 232>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* ks = reinterpret_cast<T*>(sm);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  T* qs = reinterpret_cast<T*>(sm + C::Q_OFF);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  float* stat_s = reinterpret_cast<float*>(sm + C::STAT_OFF);  // [ST][2][BM]
  float4* xp = reinterpret_cast<float4*>(sm + C::XP_OFF);      // [BM/8][128]
  uint4* xds = reinterpret_cast<uint4*>(sm + C::XDS_OFF);      // [BM/16][128]
  int2* xe = reinterpret_cast<int2*>(sm + C::XE_OFF);  // fp16: [128] exponents
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + ST;
  uint64_t* empty = do_full + ST;

  const int k0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * C::CW;  // the CTA's columns of dK and dV
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int num_q = (Sq + BM - 1) / BM;
  // first query tile whose last row q_off + (i+1)·BM − 1 reaches key k0
  const int i0 = causal ? max(0, k0 - q_off) / BM : 0;
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes
      mbar_init(&do_full[s], 32);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads, the lanes stage
    // the tile's lse (in log2 units) and δ
    Regs::producer();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        tma_rows<D>(ks, &tk, kv_full, BN, h, k0, b);
        tma_rows<D>(vs, &tv, kv_full, BN, h, k0, b);
      }
      for (int i = i0; i < num_q; ++i) {
        const int it = i - i0, s = it % ST;
        const int q0 = i * BM;
        float* lse_s = stat_s + s * 2 * BM;
        float* del_s = lse_s + BM;
        float lv[BM / 32], dl[BM / 32];  // loaded before the wait
#pragma unroll
        for (int x = 0; x < BM / 32; ++x) {
          const int r = q0 + lane + 32 * x;
          lv[x] = r < Sq ? lse[stat + r] * LOG2E : 0.f;
          dl[x] = r < Sq ? delta[stat + r] : 0.f;
        }
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
#pragma unroll
        for (int x = 0; x < BM / 32; ++x) lse_s[lane + 32 * x] = lv[x];
        if (lane == 0) {
          mbar_expect_tx(&q_full[s], C::T_BYTES);
          tma_rows<D>(qs + s * BM * D, &tq, &q_full[s], BM, h, q0, b);
        } else {
          mbar_arrive(&q_full[s]);
        }
#pragma unroll
        for (int x = 0; x < BM / 32; ++x) del_s[lane + 32 * x] = dl[x];
        if (lane == 0) {
          mbar_expect_tx(&do_full[s], C::T_BYTES);
          tma_rows<D>(dos + s * BM * D, &tdo, &do_full[s], BM, h, q0, b);
        } else {
          mbar_arrive(&do_full[s]);
        }
      }
      trap_if_stalled();
    }
  } else {
    // ---- consumers: warpgroup 0 Sᵀ and Pᵀ, warpgroup 1 dPᵀ and dSᵀ; each
    // dK and dV for its half of the chunk
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    const int col0 = c0 + cw * HW;  // the warpgroup's first column
    const float sl2 = scale * LOG2E;

    float dka[HW / 2], dva[HW / 2];
#pragma unroll
    for (int e = 0; e < HW / 2; ++e) dka[e] = dva[e] = 0.f;
    float sc[BM / 2];  // Sᵀ, then Pᵀ (warpgroup 0); dPᵀ, then dSᵀ (1)
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
    const T* a_tile = cw ? vs : ks;
    // fp16: the exponents of the thread's two key rows (header), the same
    // in both warpgroups
    int ex[2] = {E_MAX, E_MAX};
    // fp16: dK's rows times 2^(en − ex) where an exponent fell, then ex = en
    auto rescale = [&](const int (&en)[2]) {
      float f[2];
      bool fell = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        f[r] = pow2i(max(en[r] - ex[r], -126));
        fell |= en[r] < ex[r];
        ex[r] = en[r];
      }
      if (__any_sync(0xffffffffu, fell)) {
#pragma unroll
        for (int c = 0; c < HW / 8; ++c) {
          dka[4 * c] *= f[0];
          dka[4 * c + 1] *= f[0];
          dka[4 * c + 2] *= f[1];
          dka[4 * c + 3] *= f[1];
        }
      }
    };

    // Sᵀ = K·Qᵀ (warpgroup 0) or dPᵀ = V·dOᵀ (warpgroup 1) of tile i over
    // all of D into sc, committed as one group
    auto issue_score = [&](int i) {
      const int it = i - i0, s = it % ST;
      const uint32_t ph = (it / ST) & 1;
      mbar_wait(&q_full[s], ph);
      mbar_wait(&do_full[s], ph);
      const uint64_t ad = kmajor_desc(a_tile, 0);
      const uint64_t bd = kmajor_desc((cw ? dos : qs) + s * BM * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM, T>(sc, ad + kmajor_step(BN, kk),
                        bd + kmajor_step(BM, kk), kk > 0);
      wgmma_commit();
    };
    // Warpgroup 0: Pᵀ of tile i from Sᵀ, handed over; the mask is a pass of
    // its own behind a uniform branch
    auto p_out = [&](int i) {
      const int q0 = i * BM;
      const float* lse_s = stat_s + ((i - i0) % ST) * 2 * BM;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float2 ls =
            *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t);
        sc[4 * c] = fmaf(sc[4 * c], sl2, -ls.x);
        sc[4 * c + 1] = fmaf(sc[4 * c + 1], sl2, -ls.y);
        sc[4 * c + 2] = fmaf(sc[4 * c + 2], sl2, -ls.x);
        sc[4 * c + 3] = fmaf(sc[4 * c + 3], sl2, -ls.y);
      }
      if (q0 + BM > Sq || (causal && q_off + q0 < k0 + BN - 1)) {
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + 8 * c + 2 * t + (e & 1);
            if (qpos >= Sq || (causal && q_off + qpos < key[e >> 1]))
              sc[4 * c + e] = NEG_INF;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * c + e] = fast_exp2(sc[4 * c + e]);
        xp[c * WG_THREADS + tid] = make_float4(sc[4 * c], sc[4 * c + 1],
                                               sc[4 * c + 2], sc[4 * c + 3]);
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        acc_to_a<BM / 2, T>(pa[kk], sc, kk);
      asm volatile("bar.arrive 3, 256;" ::: "memory");  // Pᵀ is out
    };
    // Warpgroup 0: dSᵀ of the same tile, from warpgroup 1 (fp16: with its
    // rows' exponents, and dK's rows rescaled where they fell)
    auto ds_in = [&]() {
      asm volatile("bar.sync 4, 256;" ::: "memory");  // dSᵀ is in
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint4 x = xds[kk * WG_THREADS + tid];
        dsa[kk][0] = x.x;
        dsa[kk][1] = x.y;
        dsa[kk][2] = x.z;
        dsa[kk][3] = x.w;
      }
      if constexpr (SCALED) {
        const int2 e = xe[tid];
        const int en[2] = {e.x, e.y};
        rescale(en);
      }
    };
    // Warpgroup 1: dSᵀ of tile i from dPᵀ and warpgroup 0's Pᵀ, handed back
    // (fp16: under its rows' new exponents, which go with it, dK's rows
    // rescaled where they fell)
    auto ds_out = [&](int i) {
      const float* del_s = stat_s + ((i - i0) % ST) * 2 * BM + BM;
      asm volatile("bar.sync 3, 256;" ::: "memory");  // Pᵀ is in
      float mx[2] = {0.f, 0.f};  // fp16: the rows' largest |dSᵀ| / scale
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float4 p = xp[c * WG_THREADS + tid];
        const float2 dl =
            *reinterpret_cast<const float2*>(del_s + 8 * c + 2 * t);
        if constexpr (SCALED) {
          sc[4 * c] = p.x * (sc[4 * c] - dl.x);
          sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl.y);
          sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl.x);
          sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl.y);
          mx[0] = fmaxf(mx[0], fmaxf(fabsf(sc[4 * c]), fabsf(sc[4 * c + 1])));
          mx[1] = fmaxf(mx[1],
                        fmaxf(fabsf(sc[4 * c + 2]), fabsf(sc[4 * c + 3])));
        } else {
          sc[4 * c] = p.x * (sc[4 * c] - dl.x) * scale;
          sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl.y) * scale;
          sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl.x) * scale;
          sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl.y) * scale;
        }
        pa[c / 2][2 * (c % 2)] = pack2<T>(p.x, p.y);
        pa[c / 2][2 * (c % 2) + 1] = pack2<T>(p.z, p.w);
      }
      if constexpr (SCALED) {
        // each row's exponent, handed over beside dSᵀ; dK's rows rescaled
        // where it fell; then dSᵀ times scale·2^e
        int en[2];
        float fs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          en[r] = ds_exponent(quad_max(mx[r]) * scale, ex[r]);
          fs[r] = scale * pow2i(en[r]);
        }
        xe[tid] = make_int2(en[0], en[1]);
        rescale(en);
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * c + e] *= fs[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        acc_to_a<BM / 2, T>(dsa[kk], sc, kk);
        xds[kk * WG_THREADS + tid] =
            make_uint4(dsa[kk][0], dsa[kk][1], dsa[kk][2], dsa[kk][3]);
      }
      asm volatile("bar.arrive 4, 256;" ::: "memory");  // dSᵀ is out
    };
    // dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half] of
    // tile i, committed as one group
    auto issue_grads = [&](int i) {
      const int s = (i - i0) % ST;
      const int part = (col0 / 64) * BM * 64;
      const uint64_t dd = mnmajor_desc(dos + s * BM * D + part, BM);
      const uint64_t qd = mnmajor_desc(qs + s * BM * D + part, BM);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<HW, T>(dva, pa[kk], dd + mnmajor_step(kk));
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<HW, T>(dka, dsa[kk], qd + mnmajor_step(kk));
      wgmma_commit();
    };

    // Tile by tile: issuing the next tile's score product before this
    // tile's handoff and dV, dK (two stages fit at D=256) measured within
    // 2% of this order (scripts/torch_kernel_ablate.py on an H100), so the
    // simpler order stays.
    mbar_wait(kv_full, 0);
    for (int i = i0; i < num_q; ++i) {
      issue_score(i);
      wgmma_wait<0>();
      fence_regs(sc);
      if (cw == 0) {
        p_out(i);
        ds_in();
      } else {
        ds_out(i);
      }
      issue_grads(i);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[(i - i0) % ST]);
    }

    const int rs = H * D;
    const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D + col0;
    if constexpr (SCALED)
      store_acc_rows<HW>(dk + koff, dka, key[0], Sk, rs, pow2i(-ex[0]),
                         pow2i(-ex[1]), t);
    else
      store_acc_rows<HW>(dk + koff, dka, key[0], Sk, rs, 1.f, 1.f, t);
    store_acc_rows<HW>(dv + koff, dva, key[0], Sk, rs, 1.f, 1.f, t);
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    int q_off, int causal, float scale, cudaStream_t st) {
  using C = DkvWide<D, T>;
  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dkv_wide_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid((Sk + C::BN - 1) / C::BN, D / C::CW, B * H);
  flash_dkv_wide_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel at D = 256, 384 or 512 on tensors of T; 1
// (cudaErrorInvalidValue) at any other width.
template <typename T>
int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Sq, int Sk, int D, int q_off, int causal,
              float scale, cudaStream_t st) {
  if (D == 256)
    return launch_dkv_wide<256, T>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, q_off, causal, scale, st);
  if (D == 384)
    return launch_dkv_wide<384, T>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, q_off, causal, scale, st);
  if (D == 512)
    return launch_dkv_wide<512, T>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, q_off, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------- widths above 512
//
// flash_dkv_chunked_kernel: K3 at any D that is a multiple of 128 (the bf16
// and fp16 entries send it D > 512). Bound at
// B=8, H=2, S=2048, D=640, causal: four products of 42.9 GFLOP each, halved
// under the mask, 174 µs at 989 TFLOP/s, against six [B,S,H,D] 16-bit
// tensors and two row statistics ≈ 126 MB, 38 µs: compute-bound.
//
// Design: flash_dkv_wide_kernel's split of the work, with the contraction
// of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over D streamed in chunks (K and V over
// D=640 would take 80 KB each, resident).
// - A CTA owns BN = 64 keys of one (b, h) and a chunk of dK and dV CW
//   columns wide (the grid's y axis; cw_dkv below). One producer warpgroup
//   (warp 0: lane 0 issues the TMA loads, the lanes stage each query tile's
//   lse and δ) and two consumer warpgroups.
// - For each tile of BM = 64 query rows the producer streams D in KC =
//   64-column chunks through a ring of STAGES stages, each holding the
//   chunk's K and V (the CTA's keys) and Q and dO (the tile's rows), then Q
//   and dO over the CTA's own CW columns, the operands of dK's and dV's
//   products, with the tile's lse and δ through a ring of one stage (loaded
//   once the tile's first chunks are in flight, after the last tile's
//   products have released it). Those columns are read twice a tile, in
//   the sums and as operands: keeping their chunks' stages alive instead
//   would save 2·BM·CW of the tile's (4·BM·D + 2·BM·CW)·2 bytes (9% at
//   D=640), at the price of a chunk order that differs between the CTAs of
//   a key block, and so of their exponents: not done.
// - Warpgroup 0 sums Sᵀ and warpgroup 1 dPᵀ in registers over the D/KC
//   chunk products (wgmma m64nBMk16, both operands K-major), one commit
//   group a chunk, each chunk's stage released as in
//   flash_dq_chunked_kernel (flash_dq_wide.cu), the first chunk of a tile
//   issued apart.
// - Then as in flash_dkv_wide_kernel: warpgroup 0 turns Sᵀ into Pᵀ and hands
//   it to warpgroup 1 (named barrier 3), which forms dSᵀ and hands it back
//   as A fragments of T (named barrier 4); each warpgroup runs
//   dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half] of the
//   CTA's chunk (m64n(CW/2)k16, Q and dO read MN-major through the
//   transpose bit), dK and dV in registers.
// - Each of the D/CW CTAs of a key block computes the same Sᵀ, dPᵀ and dSᵀ:
//   the products do (2·D/CW + 2)/4 times the operations of the bound (3.0
//   at D=640). K and V are read again for every query tile, from L2.
// - Causal: the loop starts at the first query tile whose last row reaches
//   the CTA's first key; only tiles that cross the diagonal or the ragged
//   end of Sq are masked (Pᵀ = 0 there, so dSᵀ = 0). A key block that no
//   query sees writes zeros. Keys past Sk arrive as zeros and are never
//   stored.
//
// fp16: dSᵀ under the per-key-row power of two of flash_dkv_wide_kernel
// (header). Each CTA keeps its own exponents; the CTAs of a key block agree
// on every row's, as they sum the same chunks in the same order.
// bf16: none of the exponent work is compiled (`if constexpr (SCALED)`): Pᵀ
// and dSᵀ = Pᵀ∘(dPᵀ − δ)·scale are rounded to bf16 as they stand, as the
// Pallas kernel rounds them; the shared layout is fp16's, the exponents'
// slot unused.
// δ is read from `delta`, which the dQ kernel wrote earlier on the same
// stream; lse and δ are staged by plain loads (a TMA of them hung the ring
// at Sq=65, where a head's start is not 16-byte aligned).
//
// Shared memory (plus 1 KB to align the base, and the mbarriers): a stage
// (K, V, Q, dO 8 KB each) is 32 KB; the own columns' stage 4·BM·CW bytes
// (32 KB at CW=128) and lse, δ 0.5 KB; the exchange Pᵀ 16 KB, dSᵀ 8 KB, the
// exponents 1 KB: at CW=128 4 stages 128 KB + 32.5 KB + 25 KB = 186 KB.
// Registers (setmaxnreg: 40 for the producer warpgroup, 232 a consumer
// thread): dK and dV CW/4 fp32 each, Sᵀ or dPᵀ BM/2 = 32 fp32, Pᵀ and dSᵀ as
// A fragments BM/4 = 16 each. chip_smoke.py phase 2 refuses a spill at
// D=640's instantiation (CW=128) and logs CW=256.
// Where the time goes at D=640, B=8, H=2, S=2048 (scripts/
// torch_kernel_ablate.py --shape d640 --dtype fp16 on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit, 3 rounds): the chunks' loads 40% (loaded
// for the first stages only: 0.600 of the time), the products past D's
// first chunk 0.3%; 128-column chunks (two stages) are 1.11× slower. In
// bf16 (--dtype bf16, the same card): the loads 42% (0.581 of the time),
// the products past D's first chunk within the spread (0.995).

template <int CW>
struct DkvChunked {
  static constexpr int BN = 64;   // keys of a CTA
  static constexpr int BM = 64;   // query rows of a tile
  static constexpr int KC = 64;   // columns of D in a stage
  static constexpr int HW = CW / 2;  // a consumer warpgroup's half
  static constexpr int CHUNK_BYTES = BN * KC * 2;  // a chunk of K, V, Q, dO
  static constexpr int STAGE_BYTES = 4 * CHUNK_BYTES;
  static constexpr int QD_BYTES = BM * CW * 2;  // Q or dO over CW columns
  static constexpr int STAT_BYTES = 2 * BM * 4;  // lse, δ
  // the exchange: Pᵀ as fp32, dSᵀ as A fragments, fp16's exponents
  static constexpr int XCHG_BYTES = 256 * BM + 128 * BM + 8 * WG_THREADS;
  // the stages that fit beside the own columns and the exchange, at most 4
  static constexpr int FIT = (MAX_SMEM - 1024 - 2 * QD_BYTES - STAT_BYTES -
                              XCHG_BYTES - 8 * (2 * 4 + 2)) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int V_OFF = STAGES * CHUNK_BYTES;
  static constexpr int Q_OFF = 2 * STAGES * CHUNK_BYTES;
  static constexpr int DO_OFF = 3 * STAGES * CHUNK_BYTES;
  static constexpr int QW_OFF = 4 * STAGES * CHUNK_BYTES;  // own columns
  static constexpr int DOW_OFF = QW_OFF + QD_BYTES;
  static constexpr int STAT_OFF = DOW_OFF + QD_BYTES;
  static constexpr int XP_OFF = STAT_OFF + STAT_BYTES;
  static constexpr int XDS_OFF = XP_OFF + 256 * BM;
  static constexpr int XE_OFF = XDS_OFF + 128 * BM;
  static constexpr int BAR_OFF = XE_OFF + 8 * WG_THREADS;
  // full[STAGES], empty[STAGES], qd_full, qd_empty
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 2);
  static_assert(BN == BM, "a stage's four chunks share one size");
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "the ring does not fit");
};

template <int CW, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_chunked_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int Sq, int Sk, int D, int q_off, int causal,
                             float scale) {
  using C = DkvChunked<CW>;
  constexpr bool SCALED = std::is_same<T, f16>::value;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, ST = C::STAGES;
  constexpr int HW = C::HW;
  // The producer warp also stages lse and δ, so it keeps 40 registers.
  using Regs = RegSplit<40, 232>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* ks = reinterpret_cast<T*>(sm);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  T* qs = reinterpret_cast<T*>(sm + C::Q_OFF);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  T* qw = reinterpret_cast<T*>(sm + C::QW_OFF);
  T* dow = reinterpret_cast<T*>(sm + C::DOW_OFF);
  float* lse_s = reinterpret_cast<float*>(sm + C::STAT_OFF);  // [BM], log2
  float* del_s = lse_s + BM;                                  // [BM]
  float4* xp = reinterpret_cast<float4*>(sm + C::XP_OFF);     // [BM/8][128]
  uint4* xds = reinterpret_cast<uint4*>(sm + C::XDS_OFF);     // [BM/16][128]
  int2* xe = reinterpret_cast<int2*>(sm + C::XE_OFF);  // fp16: [128] exponents
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* qd_full = empty + ST;
  uint64_t* qd_empty = qd_full + 1;

  const int k0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * CW;  // the CTA's columns of dK and dV
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int num_q = (Sq + BM - 1) / BM;
  // first query tile whose last row q_off + (i+1)·BM − 1 reaches key k0
  const int i0 = causal ? max(0, k0 - q_off) / BM : 0;
  const int nc = D / KC;  // chunks of D a tile's Sᵀ and dPᵀ sum over
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init(qd_full, 32);  // the producer warp's lanes
    mbar_init(qd_empty, 2 * WG_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: warp 0 keeps both rings full, in the order the
    // consumers take them; lane 0 issues the TMA loads
    Regs::producer();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int qd_at = min(ST, nc) - 1;  // the chunk after which the own
      int it = 0;                         // columns' stage; chunks issued
      for (int i = i0; i < num_q; ++i) {
        const int q0 = i * BM, n = i - i0;
        for (int c = 0; c < nc; ++c, ++it) {
          if (lane == 0) {
            const int s = it % ST;
            mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
            mbar_expect_tx(&full[s], C::STAGE_BYTES);
            tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, k0, b,
                         c * KC);
            tma_rows<KC>(vs + s * BN * KC, &tv, &full[s], BN, h, k0, b,
                         c * KC);
            tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b,
                         c * KC);
            tma_rows<KC>(dos + s * BM * KC, &tdo, &full[s], BM, h, q0, b,
                         c * KC);
          }
          if (c == qd_at) {
            // the ring is full of this tile's chunks: the consumers are done
            // with the last tile's products, or soon will be
            float lv[BM / 32], dl[BM / 32];  // loaded before the wait
#pragma unroll
            for (int x = 0; x < BM / 32; ++x) {
              const int r = q0 + lane + 32 * x;
              lv[x] = r < Sq ? lse[stat + r] * LOG2E : 0.f;
              dl[x] = r < Sq ? delta[stat + r] : 0.f;
            }
            mbar_wait(qd_empty, (n & 1) ^ 1);
#pragma unroll
            for (int x = 0; x < BM / 32; ++x) {
              lse_s[lane + 32 * x] = lv[x];
              del_s[lane + 32 * x] = dl[x];
            }
            if (lane == 0) {
              mbar_expect_tx(qd_full, 2 * C::QD_BYTES);
              tma_rows<CW>(qw, &tq, qd_full, BM, h, q0, b, c0);
              tma_rows<CW>(dow, &tdo, qd_full, BM, h, q0, b, c0);
            } else {
              mbar_arrive(qd_full);
            }
          }
        }
      }
      trap_if_stalled();
    }
  } else {
    // ---- consumers: warpgroup 0 Sᵀ and Pᵀ, warpgroup 1 dPᵀ and dSᵀ; each
    // dK and dV for its half of the chunk
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    const int col0 = c0 + cw * HW;  // the warpgroup's first column
    const float sl2 = scale * LOG2E;

    float dka[HW / 2], dva[HW / 2];
#pragma unroll
    for (int e = 0; e < HW / 2; ++e) dka[e] = dva[e] = 0.f;
    float sc[BM / 2];  // Sᵀ, then Pᵀ (warpgroup 0); dPᵀ, then dSᵀ (1)
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
    // fp16: the exponents of the thread's two key rows, the same in both
    // warpgroups
    int ex[2] = {E_MAX, E_MAX};
    // fp16: dK's rows times 2^(en − ex) where an exponent fell, then ex = en
    auto rescale = [&](const int (&en)[2]) {
      float f[2];
      bool fell = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        f[r] = pow2i(max(en[r] - ex[r], -126));
        fell |= en[r] < ex[r];
        ex[r] = en[r];
      }
      if (__any_sync(0xffffffffu, fell)) {
#pragma unroll
        for (int c = 0; c < HW / 8; ++c) {
          dka[4 * c] *= f[0];
          dka[4 * c + 1] *= f[0];
          dka[4 * c + 2] *= f[1];
          dka[4 * c + 3] *= f[1];
        }
      }
    };

    // The products of chunk `it` into sc, committed as one group: Sᵀ = K·Qᵀ
    // (warpgroup 0) or dPᵀ = V·dOᵀ (warpgroup 1) over the chunk's KC
    // columns; the first chunk of a tile (`first`, a constant at each
    // call) overwrites sc.
    auto issue_chunk = [&](int it, bool first) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint64_t ad = kmajor_desc((cw ? vs : ks) + s * BN * KC, 0);
      const uint64_t bd = kmajor_desc((cw ? dos : qs) + s * BM * KC, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_ss<BM, T>(sc, ad + kmajor_step(BN, kk),
                        bd + kmajor_step(BM, kk), !first || kk > 0);
      wgmma_commit();
    };
    // Sᵀ or dPᵀ of the tile `n` tiles past i0, summed over the nc chunks of
    // D as they arrive, each chunk's stage released once the next chunk is
    // issued and its own products are done
    auto issue_scores = [&](int n) {
      issue_chunk(n * nc, true);
      for (int c = 1; c < nc; ++c) {
        issue_chunk(n * nc + c, false);
        wgmma_wait<1>();
        mbar_arrive(&empty[(n * nc + c - 1) % ST]);
      }
    };
    // Warpgroup 0: Pᵀ of tile i from Sᵀ, handed over; the mask is a pass of
    // its own behind a uniform branch
    auto p_out = [&](int i) {
      const int q0 = i * BM;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float2 ls =
            *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t);
        sc[4 * c] = fmaf(sc[4 * c], sl2, -ls.x);
        sc[4 * c + 1] = fmaf(sc[4 * c + 1], sl2, -ls.y);
        sc[4 * c + 2] = fmaf(sc[4 * c + 2], sl2, -ls.x);
        sc[4 * c + 3] = fmaf(sc[4 * c + 3], sl2, -ls.y);
      }
      if (q0 + BM > Sq || (causal && q_off + q0 < k0 + BN - 1)) {
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + 8 * c + 2 * t + (e & 1);
            if (qpos >= Sq || (causal && q_off + qpos < key[e >> 1]))
              sc[4 * c + e] = NEG_INF;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * c + e] = fast_exp2(sc[4 * c + e]);
        xp[c * WG_THREADS + tid] = make_float4(sc[4 * c], sc[4 * c + 1],
                                               sc[4 * c + 2], sc[4 * c + 3]);
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        acc_to_a<BM / 2, T>(pa[kk], sc, kk);
      asm volatile("bar.arrive 3, 256;" ::: "memory");  // Pᵀ is out
    };
    // Warpgroup 0: dSᵀ of the same tile, from warpgroup 1 (fp16: with its
    // rows' exponents, and dK's rows rescaled where they fell)
    auto ds_in = [&]() {
      asm volatile("bar.sync 4, 256;" ::: "memory");  // dSᵀ is in
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint4 x = xds[kk * WG_THREADS + tid];
        dsa[kk][0] = x.x;
        dsa[kk][1] = x.y;
        dsa[kk][2] = x.z;
        dsa[kk][3] = x.w;
      }
      if constexpr (SCALED) {
        const int2 e = xe[tid];
        const int en[2] = {e.x, e.y};
        rescale(en);
      }
    };
    // Warpgroup 1: dSᵀ of the tile from dPᵀ and warpgroup 0's Pᵀ, handed
    // back (fp16: under its rows' new exponents, which go with it, dK's
    // rows rescaled where they fell)
    auto ds_out = [&]() {
      asm volatile("bar.sync 3, 256;" ::: "memory");  // Pᵀ is in
      float mx[2] = {0.f, 0.f};  // fp16: the rows' largest |dSᵀ| / scale
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const float4 p = xp[c * WG_THREADS + tid];
        const float2 dl =
            *reinterpret_cast<const float2*>(del_s + 8 * c + 2 * t);
        if constexpr (SCALED) {
          sc[4 * c] = p.x * (sc[4 * c] - dl.x);
          sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl.y);
          sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl.x);
          sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl.y);
          mx[0] = fmaxf(mx[0], fmaxf(fabsf(sc[4 * c]), fabsf(sc[4 * c + 1])));
          mx[1] = fmaxf(mx[1],
                        fmaxf(fabsf(sc[4 * c + 2]), fabsf(sc[4 * c + 3])));
        } else {
          sc[4 * c] = p.x * (sc[4 * c] - dl.x) * scale;
          sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl.y) * scale;
          sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl.x) * scale;
          sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl.y) * scale;
        }
        pa[c / 2][2 * (c % 2)] = pack2<T>(p.x, p.y);
        pa[c / 2][2 * (c % 2) + 1] = pack2<T>(p.z, p.w);
      }
      if constexpr (SCALED) {
        // each row's exponent, handed over beside dSᵀ; dK's rows rescaled
        // where it fell; then dSᵀ times scale·2^e
        int en[2];
        float fs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          en[r] = ds_exponent(quad_max(mx[r]) * scale, ex[r]);
          fs[r] = scale * pow2i(en[r]);
        }
        xe[tid] = make_int2(en[0], en[1]);
        rescale(en);
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * c + e] *= fs[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        acc_to_a<BM / 2, T>(dsa[kk], sc, kk);
        xds[kk * WG_THREADS + tid] =
            make_uint4(dsa[kk][0], dsa[kk][1], dsa[kk][2], dsa[kk][3]);
      }
      asm volatile("bar.arrive 4, 256;" ::: "memory");  // dSᵀ is out
    };
    // dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half] of
    // the tile over the CTA's own columns, committed as one group
    auto issue_grads = [&]() {
      const int part = cw * (HW / 64) * BM * 64;
      const uint64_t dd = mnmajor_desc(dow + part, BM);
      const uint64_t qd = mnmajor_desc(qw + part, BM);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<HW, T>(dva, pa[kk], dd + mnmajor_step(kk));
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs<HW, T>(dka, dsa[kk], qd + mnmajor_step(kk));
      wgmma_commit();
    };

    for (int i = i0; i < num_q; ++i) {
      const int n = i - i0;
      issue_scores(n);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&empty[(n * nc + nc - 1) % ST]);
      mbar_wait(qd_full, n & 1);  // lse, δ and the own columns
      if (cw == 0) {
        p_out(i);
        ds_in();
      } else {
        ds_out();
      }
      issue_grads();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(qd_empty);
    }

    const int rs = H * D;
    const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D + col0;
    if constexpr (SCALED)
      store_acc_rows<HW>(dk + koff, dka, key[0], Sk, rs, pow2i(-ex[0]),
                         pow2i(-ex[1]), t);
    else
      store_acc_rows<HW>(dk + koff, dka, key[0], Sk, rs, 1.f, 1.f, t);
    store_acc_rows<HW>(dv + koff, dva, key[0], Sk, rs, 1.f, 1.f, t);
    trap_if_stalled();
  }
}

template <int CW, typename T>
int launch_dkv_chunked(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       int D, int q_off, int causal, float scale,
                       cudaStream_t st) {
  using C = DkvChunked<CW>;
  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dkv_chunked_kernel<CW, T>),
        C::SMEM);
  if (err) return err;
  const dim3 grid((Sk + C::BN - 1) / C::BN, D / CW, B * H);
  flash_dkv_chunked_kernel<CW, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The chunk of dK and dV a CTA of the chunked kernel owns at head width D:
// 256 columns where D divides by 256, else 128.
inline int cw_dkv(int D) { return D % 256 == 0 ? 256 : 128; }

// The chunked kernel on tensors of T at any D that is a multiple of 128.
template <typename T>
int dkv_chunked(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                int q_off, int causal, float scale, cudaStream_t st) {
  if (cw_dkv(D) == 256)
    return launch_dkv_chunked<256, T>(q, k, v, dout, lse, delta, dk, dv, B,
                                      H, Sq, Sk, D, q_off, causal, scale, st);
  return launch_dkv_chunked<128, T>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Sq, Sk, D, q_off, causal, scale, st);
}

}  // namespace voda

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
// D = 256, 384, 512: flash_dkv_wide_kernel; any multiple of 128 above 512:
// flash_dkv_chunked_kernel.
extern "C" int voda_flash_dkv_wide(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, int q_off, int causal,
                                   float scale, void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return dkv_chunked<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                             D, q_off, causal, scale, st);
  return dkv_wgmma<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D,
                         q_off, causal, scale, st);
}

// fp16 tensors, the same arguments and the same kernels.
extern "C" int voda_flash_dkv_f16_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int q_off,
                                       int causal, float scale,
                                       void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return dkv_chunked<f16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                            D, q_off, causal, scale, st);
  return dkv_wgmma<f16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D,
                        q_off, causal, scale, st);
}
