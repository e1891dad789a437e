// K2 for head widths above 128: dQ of flash attention for Hopper (sm_90a)
// at any D that is a multiple of 128.
//
// Replaces `_dq_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched by `_bwd`) where the JAX package takes D > 128; flash_dq.cu
// keeps D = 64 and 128. With P = exp(S·scale − lse) recomputed from the
// forward's lse and δ = rowsum(dO∘O): dS = P∘(dO·Vᵀ − δ)·scale and
// dQ = dS·K. It also writes δ to `delta` [B, H, Sq], once per row, for the
// dK/dV kernel (flash_dkv_wide.cu) launched after it on the same stream.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): three products of
// 2·B·H·Sq·Sk·D FLOPs (S, dP, dS·K), halved under the causal mask: at B=8,
// H=4, S=2048, D=256, 103 GFLOP, 104 µs, against six [B,S,H,D] bf16
// tensors and two row statistics ≈ 201 MB, 60 µs: compute-bound (the same
// at B=8, H=2, D=512).
//
// Design (D = 256, 384, 512), flash_dkv_wide.cu's with queries for keys:
// - A CTA owns BM = 64 query rows of one (b, h) across the whole of D, so
//   each S and dP is computed once. One producer warpgroup (one thread
//   issues every TMA load) and two consumer warpgroups.
// - Q and dO arrive once by TMA and stay. K and V tiles of BN keys over all
//   of D pass through a ring of STAGES stages, with a "full" mbarrier each
//   for K and V and one "empty" that the 256 consumer threads arrive on
//   after dQ += dS·K, the stage's last reader.
// - The consumers split the work of a tile by operand, and dQ by halves.
//   Warpgroup 0 computes S = Q·Kᵀ and warpgroup 1 dP = dO·Vᵀ, each once,
//   over all of D (wgmma m64nBNk16, both operands K-major in shared
//   memory). Warpgroup 0 turns S into P·scale = exp2(S·scale·log2e − lse2)
//   on its accumulators, lse2 = lse·log2e − log2 scale held in registers
//   (the scale rides in the exponent, as in flash_dq.cu), and hands it to
//   warpgroup 1 as fp32 through shared memory (named barrier 3); warpgroup
//   1 computes dS = P·scale∘(dP − δ) and hands it back as bf16 A fragments
//   (named barrier 4). Both layouts are the accumulator's own, thread by
//   thread, so the exchange is a conflict-free 16-byte store and load a
//   thread. Then each warpgroup runs dQ[:, half] += dS·K[:, half] (wgmma
//   m64n(D/2)k16, A from registers, B the same K stage read MN-major
//   through the transpose bit), dQ staying in registers.
// - δ: warpgroup 1 computes it under its first dP product, from dO in
//   shared memory (a thread reads a quarter of each of its two rows, in
//   flash_dq.cu's conflict-free order, and the quad sums) and O read once
//   from device memory, and writes it out. O is needed for nothing else:
//   resident it would take another 32 KB at D=256, where two stages leave
//   10 KB; passed through a stage it would hold up the first K and V.
// - Causal: key tiles past the block's last row are never loaded; only
//   tiles that cross the diagonal or the ragged end of Sk are masked. The
//   query tile is the grid's fastest axis, reversed: the long tiles of
//   each head start first and the CTAs in flight share a few heads' K and
//   V in L2.
// - Rows past Sq arrive from TMA as zeros, take lse 0 and δ 0 (so dS = 0)
//   and are never stored; keys past Sk arrive as zeros and are masked.
//
// Shared memory, of the 227 KB (plus 1 KB to align the base to the
// swizzle's 1024 bytes, and the mbarriers), bf16 (fp16 adds the exponents'
// 1 KB, below):
//   D=256, BN=64: Q, dO 64 KB + 2 × (K, V 64 KB) + P 16 KB + dS 8 KB = 216 KB
//   D=384, BN=32: Q, dO 96 KB + 2 × (K, V 48 KB) + 12 KB = 204 KB
//   D=512, BN=32: Q, dO 128 KB + 1 × (K, V 64 KB) + 12 KB = 204 KB; with one
//                 stage a tile's loads wait for the last tile's products.
// Registers: setmaxnreg gives the producer 24 and each consumer thread 240.
// A consumer holds its half of dQ (D/4 fp32: 64 at D=256, 128 at D=512),
// S or dP (BN/2 fp32) and dS as A fragments (BN/4); fp16 adds the two
// exponents of the thread's rows and, for the tile's scale, a few registers
// more. ptxas spills nothing at D=256, 384 or 512 (chip_smoke.py phase 2
// refuses a spill at D=256).
// Where the time goes (scripts/torch_kernel_ablate.py on an H100, two runs
// of 3 rounds): at D=256 the handoff waits 6-9%, the exponentials 0-3%, the
// K/V loads no more than the spread; at D=512 the single stage's loads 21%.
//
// Above D=512 Q and dO no longer fit beside a stage: both types run
// flash_dq_chunked_kernel there (below), which streams D.
//
// No atomics: each CTA writes its own rows of dQ and δ, so both are
// deterministic.
//
// fp16 (voda_flash_dq_f16_wide, D = 256, 384, 512). The same kernel on fp16
// tensors, the element type a template parameter (bf16 by default), with
// flash_dq.cu's per-query-row scale of dS carried over to this split of
// the work. wgmma takes both operands in one type, so dS is rounded to
// fp16, where an unscaled loss's dS (near 1e-8 for an output gradient of
// 1e-6) would flush below fp16's smallest normal, 6e-5. So:
// - Warpgroup 1, which forms dS, keeps a running exponent e_i for each of
//   its thread's two query rows (E_MAX at the start). For each key tile it
//   takes the row's largest |dS| over the quad that holds the row and
//   lowers e_i to the exponent that puts it in [2^13, 2^14) where that is
//   lower (ds_exponent, hopper.cuh; never below −E_MAX; a row the tile
//   masks keeps e_i), and packs dS·2^e_i to fp16 A fragments.
// - Both warpgroups accumulate dQ over the same 64 query rows, each in its
//   half of the columns, and thread tid of warpgroup 0 holds the same two
//   rows as thread tid of warpgroup 1 (the m64 accumulator layout). So
//   warpgroup 1 writes its thread's two new exponents (8 bytes) beside the
//   dS fragments in the exchange, behind the same named barrier 4, and
//   warpgroup 0 reads them with the fragments: both keep the same e_i.
// - Each warpgroup multiplies its half of dQ's row by 2^(new − old) where
//   the exponent fell (exact in fp32; behind a warp vote, so a tile with no
//   change costs one vote), after the last tile's dQ product has completed
//   and before this tile's is issued.
// - The epilogue stores dQ's row times 2^−e_i in both warpgroups.
// One CTA covers the whole head at every width, so no two CTAs need to
// agree on an exponent. The exponents' slot (1 KB) changes no width's BN
// or stages. For bf16 none of this is compiled (`if constexpr`), and its
// shared layout is the parent's.

#include "hopper.cuh"

namespace voda {

template <int D, typename T = bf16>
struct DqWide {
  // fp16: dS under a per-query-row scale, whose exponents the exchange
  // carries too (header)
  static constexpr bool SCALED = std::is_same<T, f16>::value;
  static constexpr int XE_BYTES = SCALED ? 8 * WG_THREADS : 0;
  static constexpr int BM = 64;     // query rows of a CTA
  static constexpr int HW = D / 2;  // a consumer warpgroup's half of dQ
  static constexpr int T_BYTES = BM * D * 2;  // each of Q, dO
  static constexpr int ROOM = MAX_SMEM - 1024 - 2 * T_BYTES - 8 * 8;
  // a stage of `bn` keys: K, V
  static constexpr int stage_bytes(int bn) { return 4 * bn * D; }
  // the exchange: P as fp32 and dS as A fragments of T (and, for fp16, the
  // exponents of dS's rows)
  static constexpr int xchg_bytes(int bn) {
    return 256 * bn + 128 * bn + XE_BYTES;
  }
  static constexpr int fit(int bn) {
    return (ROOM - xchg_bytes(bn)) / stage_bytes(bn);
  }
  // keys of a stage: 64 where two stages fit, else 32
  static constexpr int BN = fit(64) >= 2 ? 64 : 32;
  static constexpr int STAGES = fit(BN) < 2 ? fit(BN) : 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int DO_OFF = T_BYTES;
  static constexpr int K_OFF = 2 * T_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int XP_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int XDS_OFF = XP_OFF + 256 * BN;
  static constexpr int XE_OFF = XDS_OFF + 128 * BN;
  static constexpr int BAR_OFF = XE_OFF + XE_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
  static_assert(STAGES >= 1 && SMEM <= MAX_SMEM, "no stage fits beside Q, dO");
};

template <int D, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const T* __restrict__ o,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq,
                         int H, int Sq, int Sk, int q_off, int causal,
                         float scale) {
  using C = DqWide<D, T>;
  constexpr bool SCALED = C::SCALED;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, HW = C::HW;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  T* ks = reinterpret_cast<T*>(sm + C::K_OFF);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  float4* xp = reinterpret_cast<float4*>(sm + C::XP_OFF);  // [BN/8][128]
  uint4* xds = reinterpret_cast<uint4*>(sm + C::XDS_OFF);  // [BN/16][128]
  int2* xe = reinterpret_cast<int2*>(sm + C::XE_OFF);  // fp16: [128] exponents
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
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
      mbar_expect_tx(q_full, 2 * C::T_BYTES);
      tma_rows<D>(qs, &tq, q_full, BM, h, q0, b);
      tma_rows<D>(dos, &tdo, q_full, BM, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % ST;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_rows<D>(ks + s * BN * D, &tk, &k_full[s], BN, h, j * BN, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_rows<D>(vs + s * BN * D, &tv, &v_full[s], BN, h, j * BN, b);
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: warpgroup 0 S and P, warpgroup 1 dP, δ and dS; each
    // dQ for its half of the head
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = warp * 16 + g;  // the thread's first row in the tile
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const float sl2 = scale * LOG2E;
    const int rs = H * D;
    const size_t head = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

    // lse of the thread's rows as lse·log2e − log2 scale, read under the
    // TMA loads, so that exp2(S·sl2 − lse2) = P·scale; 0 past Sq
    float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = q0 + r_loc + 8 * r;
      lse2[r] = gr < Sq ? fmaf(lse[stat + gr], LOG2E, -log2f(scale)) : 0.f;
    }

    float acc[HW / 2];
#pragma unroll
    for (int e = 0; e < HW / 2; ++e) acc[e] = 0.f;
    float sc[BN / 2];  // S, then P·scale (warpgroup 0); dP, then dS (1)
    uint32_t dsa[BN / 16][4];
    // fp16: the exponents of the thread's two query rows (header), the same
    // in both warpgroups
    int ex[2] = {E_MAX, E_MAX};
    // fp16: dQ's rows times 2^(en − ex) where an exponent fell, then ex = en
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
          acc[4 * c] *= f[0];
          acc[4 * c + 1] *= f[0];
          acc[4 * c + 2] *= f[1];
          acc[4 * c + 3] *= f[1];
        }
      }
    };

    // S = Q·Kᵀ (warpgroup 0) or dP = dO·Vᵀ (warpgroup 1) of tile j over all
    // of D into sc, committed as one group. Warpgroup 1 also waits for K,
    // which its dQ product reads: no wait sits between two wgmma.
    auto issue_score = [&](int j) {
      const int s = j % ST;
      const uint32_t ph = (j / ST) & 1;
      mbar_wait(&k_full[s], ph);
      if (cw) mbar_wait(&v_full[s], ph);
      const uint64_t ad = kmajor_desc(cw ? dos : qs, 0);
      const uint64_t bd = kmajor_desc((cw ? vs : ks) + s * BN * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, T>(sc, ad + kmajor_step(BM, kk),
                        bd + kmajor_step(BN, kk), kk > 0);
      wgmma_commit();
    };
    // Warpgroup 1: δ of the thread's two rows, written out. Thread t of the
    // quad takes the chunks t and t + 4 of every 64-column part of dO (the
    // swizzled tile: the 8 threads of one 16-byte load phase fall on
    // distinct banks) and the same logical chunks of O; the quad sums.
    auto row_deltas = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = r_loc + 8 * r;
        float s = 0.f;
        if (q0 + lr < Sq) {
          const T* orow = o + head + static_cast<size_t>(q0 + lr) * rs;
#pragma unroll
          for (int p = 0; p < D / 64; ++p) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int pc = (t + 4 * x) ^ (4 * (g & 1));  // where it sits
              const int lc = pc ^ (lr & 7);                 // which it is
              s += dot8<T>(*reinterpret_cast<const uint4*>(
                               dos + p * BM * 64 + lr * 64 + pc * 8),
                           __ldg(reinterpret_cast<const uint4*>(
                               orow + p * 64 + lc * 8)));
            }
          }
        }
        dl[r] = quad_sum(s);
        if (t == 0 && q0 + lr < Sq) delta[stat + q0 + lr] = dl[r];
      }
    };
    // Warpgroup 0: P·scale of tile j from S, handed over; the mask is a
    // pass of its own behind a uniform branch
    auto p_out = [&](int j) {
      const int k0 = j * BN;
      if (k0 + BN > Sk || (causal && k0 + BN - 1 > q_off + q0)) {
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
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * c + e] = fast_exp2(fmaf(sc[4 * c + e], sl2, -lse2[e >> 1]));
        xp[c * WG_THREADS + tid] = make_float4(sc[4 * c], sc[4 * c + 1],
                                               sc[4 * c + 2], sc[4 * c + 3]);
      }
      asm volatile("bar.arrive 3, 256;" ::: "memory");  // P is out
    };
    // Warpgroup 0: dS of the same tile, from warpgroup 1 (fp16: with its
    // rows' exponents, and dQ's rows rescaled where they fell)
    auto ds_in = [&]() {
      asm volatile("bar.sync 4, 256;" ::: "memory");  // dS is in
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
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
    // Warpgroup 1: dS of the tile from dP and warpgroup 0's P, handed back
    // (fp16: under its rows' new exponents, which go with it, dQ's rows
    // rescaled where they fell)
    auto ds_out = [&]() {
      asm volatile("bar.sync 3, 256;" ::: "memory");  // P is in
      float mx[2] = {0.f, 0.f};  // fp16: the rows' largest |dS|
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float4 p = xp[c * WG_THREADS + tid];
        sc[4 * c] = p.x * (sc[4 * c] - dl[0]);
        sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl[0]);
        sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl[1]);
        sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl[1]);
        if constexpr (SCALED) {
          mx[0] = fmaxf(mx[0], fmaxf(fabsf(sc[4 * c]), fabsf(sc[4 * c + 1])));
          mx[1] = fmaxf(mx[1],
                        fmaxf(fabsf(sc[4 * c + 2]), fabsf(sc[4 * c + 3])));
        }
      }
      if constexpr (SCALED) {
        // each row's exponent, handed over beside dS; dQ's rows rescaled
        // where it fell; then dS times 2^e
        int en[2];
        float fs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          en[r] = ds_exponent(quad_max(mx[r]), ex[r]);
          fs[r] = pow2i(en[r]);
        }
        xe[tid] = make_int2(en[0], en[1]);
        rescale(en);
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * c + e] *= fs[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        acc_to_a<BN / 2, T>(dsa[kk], sc, kk);
        xds[kk * WG_THREADS + tid] =
            make_uint4(dsa[kk][0], dsa[kk][1], dsa[kk][2], dsa[kk][3]);
      }
      asm volatile("bar.arrive 4, 256;" ::: "memory");  // dS is out
    };
    // dQ[:, half] += dS·K[:, half] of tile j, committed as one group
    auto issue_dq = [&](int j) {
      const int s = j % ST;
      const uint64_t kd =
          mnmajor_desc(ks + s * BN * D + cw * (HW / 64) * BN * 64, BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HW, T>(acc, dsa[kk], kd + mnmajor_step(kk));
      wgmma_commit();
    };

    // Tile by tile, as in flash_dkv_wide.cu; δ is computed under the first
    // dP product. Issuing the next tile's S and dP ahead of this tile's dQ,
    // with the next handoff under dQ (two stages fit at D=256), measured
    // 1.13x slower at D=256 (scripts/torch_kernel_ablate.py on an H100),
    // and 1.43x slower where a branch around a wgmma or its wait made
    // ptxas serialise every wgmma (its warning C7514), so the simpler order
    // stays.
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_k; ++j) {
      issue_score(j);
      if (cw == 1 && j == 0) row_deltas();
      wgmma_wait<0>();
      fence_regs(sc);
      if (cw == 0) {
        p_out(j);
        ds_in();
      } else {
        ds_out();
      }
      issue_dq(j);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[j % ST]);
    }

    if constexpr (SCALED)
      store_acc_rows<HW>(dq + head + cw * HW, acc, q0 + r_loc, Sq, rs,
                         pow2i(-ex[0]), pow2i(-ex[1]), t);
    else
      store_acc_rows<HW>(dq + head + cw * HW, acc, q0 + r_loc, Sq, rs, 1.f,
                         1.f, t);
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, int B, int H, int Sq, int Sk,
                   int q_off, int causal, float scale, cudaStream_t st) {
  using C = DqWide<D, T>;
  static_assert(C::BN == DqWide<D>::BN && C::STAGES == DqWide<D>::STAGES,
                "fp16's exponents cost the tiles or the stages of bf16");
  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dq_wide_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, 1, B * H);
  flash_dq_wide_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel at D = 256, 384 or 512 on tensors of T; 1
// (cudaErrorInvalidValue) at any other width.
template <typename T>
int dq_wgmma(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq, int B,
             int H, int Sq, int Sk, int D, int q_off, int causal, float scale,
             cudaStream_t st) {
  if (D == 256)
    return launch_dq_wide<256, T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq,
                                  Sk, q_off, causal, scale, st);
  if (D == 384)
    return launch_dq_wide<384, T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq,
                                  Sk, q_off, causal, scale, st);
  if (D == 512)
    return launch_dq_wide<512, T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq,
                                  Sk, q_off, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------- widths above 512
//
// flash_dq_chunked_kernel: K2 at any D that is a multiple of 128 (the bf16
// and fp16 entries send it D > 512). Bound
// at B=8, H=2, S=2048, D=640, causal: three products of 42.9 GFLOP each,
// halved under the mask, 130 µs at 989 TFLOP/s, against six [B,S,H,D]
// 16-bit tensors and two row statistics ≈ 126 MB, 38 µs: compute-bound.
//
// Design: flash_dq_wide_kernel's split of the work, with the contraction of
// S = Q·Kᵀ and dP = dO·Vᵀ over D streamed in chunks, as
// flash_fwd_chunked_kernel (flash_fwd_wide.cu) streams S, so that the
// shared memory no longer depends on D.
// - A CTA owns BM = 64 query rows of one (b, h) and a chunk of dQ CW
//   columns wide: CW = 256 where D divides by 256, else 128 (the grid's y
//   axis). One producer warpgroup (one thread issues every TMA load) and
//   two consumer warpgroups.
// - For each tile of BN = 128 keys the producer streams D in KC = 64-column
//   chunks (one 128-byte swizzle part) through a ring of STAGES stages, each
//   holding the chunk's Q and dO (64 rows) and K and V (BN rows), then the K
//   tile of dQ's product, BN keys over the CTA's CW columns, through a ring
//   of one stage (loaded once the tile's first chunks are in flight, which
//   is after the last tile's dQ product has released it).
// - Warpgroup 0 sums S and warpgroup 1 dP in registers over the D/KC chunk
//   products (wgmma m64nBNk16, both operands K-major): each chunk's
//   products into an accumulator of their own, one commit group, which once
//   done (wgmma_wait<0>) releases the chunk's stage and adds into the
//   tile's sum in fp32 on the CUDA cores. The tensor cores truncate their
//   fp32 sums at every k-step; over all of D in one accumulator dP drifted
//   by up to 1e-4 at D=1024, and a row that sees one key, whose dP − δ
//   cancels (its dQ near 0), read 4.8e-3 against the 5e-3 of chip_smoke.py's
//   dq_row (NVIDIA H100 80GB HBM3, 700 W power limit). Each warpgroup
//   waits on its own products a chunk; the other warpgroup's fill the
//   tensor cores meanwhile.
// - Then as in flash_dq_wide_kernel: warpgroup 0 turns S into P·scale and
//   hands it to warpgroup 1 (named barrier 3), which forms dS and hands it
//   back as A fragments of T (named barrier 4); each warpgroup runs
//   dQ[:, its half of the chunk] += dS·K[:, its half] (m64n(CW/2)k16, K
//   read MN-major through the transpose bit), dQ in registers.
// - δ = rowsum(dO∘O) over all of D: warpgroup 1 of every CTA computes it
//   for its rows before the first tile, from O and dO read from device
//   memory in one fixed order (thread t of a quad takes the 16-byte chunks
//   t, t + 4, … of the row, the quad sums), so the CTAs of a row block hold
//   the same δ; the CTA of chunk 0 writes it to `delta` for K3.
// - Each of the D/CW CTAs of a row block computes the same S, dP and dS:
//   the products do (2·D/CW + 1)/3 times the operations of the bound (3.67
//   at D=640, 2.33 at 768), the price of one dS per row without atomics.
//   Q and dO are read again for every key tile, from L2, where the row
//   block's CTAs find them: 128 keys a tile halve those reads against 64,
//   as in the chunked forward (whose 64-key tiles measured 12% slower).
// - Causal: key tiles past the block's last row are never loaded; only
//   tiles that cross the diagonal or the ragged end of Sk are masked. The
//   query tiles are the grid's fastest axis, longest first. Rows past Sq
//   arrive from TMA as zeros, take lse 0 and δ 0 (so dS = 0) and are never
//   stored; keys past Sk arrive as zeros and are masked.
//
// fp16: dS under the per-query-row power of two of flash_dq_wide_kernel
// (header), warpgroup 1 handing each row's new exponent to warpgroup 0
// beside the fragments. Each CTA keeps its own running exponents and undoes
// them in its own epilogue, so nothing passes between CTAs; the CTAs of a
// row block agree on every row's exponent all the same, as they sum the
// same chunks in the same order and so form the same dS.
// bf16: the same kernel on bf16 tensors, none of the exponent work compiled
// (`if constexpr (SCALED)`): dS = P·scale∘(dP − δ) is rounded to bf16 as it
// stands, as the Pallas kernel rounds it (`ds.astype`). bf16 keeps fp32's
// exponent range, so an unscaled loss's dS (near 1e-8) does not flush. The
// shared layout is fp16's; the exponents' 1 KB slot goes unused.
//
// Shared memory (plus 1 KB to align the base, and the mbarriers): a stage
// (Q, dO 8 KB each, K, V 16 KB each) is 48 KB; the exchange P 32 KB, dS
// 16 KB, the exponents 1 KB:
//   CW=128: 3 stages 144 KB + K tile 32 KB + 49 KB = 225 KB
//   CW=256: 2 stages  96 KB + K tile 64 KB + 49 KB = 209 KB
// Registers (setmaxnreg: 24 for the producer, 240 a consumer thread): S or
// dP BN/2 = 64 fp32, a chunk's products 64 more, dS as A fragments BN/4 =
// 32, dQ CW/4 fp32 (32 at CW=128, 64 at 256). chip_smoke.py phase 2
// refuses a spill at CW=128 (D=640) and logs CW=256 (24 bytes), in both
// types (bf16 allocates as fp16 does).
// Where the time goes at D=640, B=8, H=2, S=2048 (scripts/
// torch_kernel_ablate.py --shape d640 --dtype fp16 on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit, 3 rounds): the chunks' loads 25% (loaded
// for the first stages only: 0.753 of the time), the products past D's
// first chunk 1%; 64-key tiles are 1.25× slower; the sums over all of D in
// one tensor-core accumulator, pipelined as in the chunked forward, read
// 0.995: the fp32 adds cost nothing that shows. In bf16 (--dtype bf16, the
// same card): the loads 26% (0.742 of the time), the products past D's
// first chunk 1%.

template <int CW>
struct DqChunked {
  static constexpr int BM = 64;   // query rows of a CTA
  static constexpr int BN = 128;  // keys of a tile
  static constexpr int KC = 64;   // columns of D in a stage
  static constexpr int HW = CW / 2;  // a consumer warpgroup's half of dQ
  static constexpr int T_BYTES = BM * KC * 2;   // a chunk of Q or dO
  static constexpr int KV_BYTES = BN * KC * 2;  // a chunk of K or V
  static constexpr int STAGE_BYTES = 2 * T_BYTES + 2 * KV_BYTES;
  static constexpr int KD_BYTES = BN * CW * 2;  // the K tile of dQ's product
  // the exchange: P as fp32, dS as A fragments, fp16's exponents
  static constexpr int XCHG_BYTES = 256 * BN + 128 * BN + 8 * WG_THREADS;
  // the stages that fit beside the K tile and the exchange, at most four
  static constexpr int FIT = (MAX_SMEM - 1024 - KD_BYTES - XCHG_BYTES -
                              8 * (2 * 4 + 2)) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int DO_OFF = STAGES * T_BYTES;
  static constexpr int K_OFF = 2 * STAGES * T_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int KD_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int XP_OFF = KD_OFF + KD_BYTES;
  static constexpr int XDS_OFF = XP_OFF + 256 * BN;
  static constexpr int XE_OFF = XDS_OFF + 128 * BN;
  static constexpr int BAR_OFF = XE_OFF + 8 * WG_THREADS;
  // full[STAGES], empty[STAGES], kd_full, kd_empty
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 2);
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "the ring does not fit");
};

template <int CW, typename T = bf16>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_chunked_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const T* __restrict__ o,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta, T* __restrict__ dq,
                            int H, int Sq, int Sk, int D, int q_off,
                            int causal, float scale) {
  using C = DqChunked<CW>;
  constexpr bool SCALED = std::is_same<T, f16>::value;
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, ST = C::STAGES;
  constexpr int HW = C::HW;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  T* ks = reinterpret_cast<T*>(sm + C::K_OFF);
  T* vs = reinterpret_cast<T*>(sm + C::V_OFF);
  T* kd = reinterpret_cast<T*>(sm + C::KD_OFF);
  float4* xp = reinterpret_cast<float4*>(sm + C::XP_OFF);  // [BN/8][128]
  uint4* xds = reinterpret_cast<uint4*>(sm + C::XDS_OFF);  // [BN/16][128]
  int2* xe = reinterpret_cast<int2*>(sm + C::XE_OFF);  // fp16: [128] exponents
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* kd_full = empty + ST;
  uint64_t* kd_empty = kd_full + 1;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int c0 = blockIdx.y * CW;            // the CTA's columns of dQ
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
    mbar_init(kd_full, 1);
    mbar_init(kd_empty, 2 * WG_THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer: one thread keeps both rings full, in the order the
    // consumers take them
    Regs::producer();
    if (threadIdx.x == 0) {
      const int kd_at = min(ST, nc) - 1;  // the chunk after which K's tile
      int it = 0;                         // chunks issued
      for (int j = 0; j < n_k; ++j) {
        for (int c = 0; c < nc; ++c, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b, c * KC);
          tma_rows<KC>(dos + s * BM * KC, &tdo, &full[s], BM, h, q0, b,
                       c * KC);
          tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, j * BN, b,
                       c * KC);
          tma_rows<KC>(vs + s * BN * KC, &tv, &full[s], BN, h, j * BN, b,
                       c * KC);
          if (c == kd_at) {
            // the ring is full of this tile's chunks: the consumers are done
            // with the last tile's dQ, or soon will be
            mbar_wait(kd_empty, (j & 1) ^ 1);
            mbar_expect_tx(kd_full, C::KD_BYTES);
            tma_rows<CW>(kd, &tk, kd_full, BN, h, j * BN, b, c0);
          }
        }
      }
    }
    trap_if_stalled();
  } else {
    // ---- consumers: warpgroup 0 S and P, warpgroup 1 dP, δ and dS; each
    // dQ for its half of the chunk
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = warp * 16 + g;  // the thread's first row in the tile
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const float sl2 = scale * LOG2E;
    const int rs = H * D;
    const size_t head = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

    // lse of the thread's rows as lse·log2e − log2 scale, so that
    // exp2(S·sl2 − lse2) = P·scale; 0 past Sq
    float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = q0 + r_loc + 8 * r;
      lse2[r] = gr < Sq ? fmaf(lse[stat + gr], LOG2E, -log2f(scale)) : 0.f;
    }

    float acc[HW / 2];
#pragma unroll
    for (int e = 0; e < HW / 2; ++e) acc[e] = 0.f;
    float sc[BN / 2];  // S, then P·scale (warpgroup 0); dP, then dS (1)
    float part[BN / 2];  // a chunk's products of S or dP
    uint32_t dsa[BN / 16][4];
    // fp16: the exponents of the thread's two query rows, the same in both
    // warpgroups
    int ex[2] = {E_MAX, E_MAX};
    // fp16: dQ's rows times 2^(en − ex) where an exponent fell, then ex = en
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
          acc[4 * c] *= f[0];
          acc[4 * c + 1] *= f[0];
          acc[4 * c + 2] *= f[1];
          acc[4 * c + 3] *= f[1];
        }
      }
    };

    // The products of chunk `it` (of all the tiles' chunks) into part,
    // committed as one group: S = Q·Kᵀ (warpgroup 0) or dP = dO·Vᵀ
    // (warpgroup 1) over the chunk's KC columns.
    auto issue_chunk = [&](int it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint64_t ad = kmajor_desc((cw ? dos : qs) + s * BM * KC, 0);
      const uint64_t bd = kmajor_desc((cw ? vs : ks) + s * BN * KC, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_ss<BN, T>(part, ad + kmajor_step(BM, kk),
                        bd + kmajor_step(BN, kk), kk > 0);
      wgmma_commit();
    };
    // S or dP of tile j into sc, summed over the nc chunks of D as they
    // arrive: each chunk's products into part, which, once done, releases
    // the chunk's stage and adds into sc in fp32 (header)
    auto issue_scores = [&](int j) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
      for (int c = 0; c < nc; ++c) {
        issue_chunk(j * nc + c);
        wgmma_wait<0>();
        fence_regs(part);
        mbar_arrive(&empty[(j * nc + c) % ST]);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] += part[e];
      }
    };
    // Warpgroup 1: δ of the thread's two rows over all of D, from O and dO
    // in device memory (chunks t, t + 4, … of the row, the quad summing);
    // written out by the CTA of chunk 0
    auto row_deltas = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gr = q0 + r_loc + 8 * r;
        float s = 0.f;
        if (gr < Sq) {
          const T* orow = o + head + static_cast<size_t>(gr) * rs;
          const T* drow = dout + head + static_cast<size_t>(gr) * rs;
#pragma unroll 4
          for (int x = t; x < D / 8; x += 4)
            s += dot8<T>(__ldg(reinterpret_cast<const uint4*>(drow + 8 * x)),
                         __ldg(reinterpret_cast<const uint4*>(orow + 8 * x)));
        }
        dl[r] = quad_sum(s);
        if (t == 0 && gr < Sq && blockIdx.y == 0) delta[stat + gr] = dl[r];
      }
    };
    // Warpgroup 0: P·scale of tile j from S, handed over; the mask is a
    // pass of its own behind a uniform branch
    auto p_out = [&](int j) {
      const int k0 = j * BN;
      if (k0 + BN > Sk || (causal && k0 + BN - 1 > q_off + q0)) {
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
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * c + e] = fast_exp2(fmaf(sc[4 * c + e], sl2, -lse2[e >> 1]));
        xp[c * WG_THREADS + tid] = make_float4(sc[4 * c], sc[4 * c + 1],
                                               sc[4 * c + 2], sc[4 * c + 3]);
      }
      asm volatile("bar.arrive 3, 256;" ::: "memory");  // P is out
    };
    // Warpgroup 0: dS of the same tile, from warpgroup 1 (fp16: with its
    // rows' exponents, and dQ's rows rescaled where they fell)
    auto ds_in = [&]() {
      asm volatile("bar.sync 4, 256;" ::: "memory");  // dS is in
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
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
    // Warpgroup 1: dS of the tile from dP and warpgroup 0's P, handed back
    // (fp16: under its rows' new exponents, which go with it, dQ's rows
    // rescaled where they fell)
    auto ds_out = [&]() {
      asm volatile("bar.sync 3, 256;" ::: "memory");  // P is in
      float mx[2] = {0.f, 0.f};  // fp16: the rows' largest |dS|
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float4 p = xp[c * WG_THREADS + tid];
        sc[4 * c] = p.x * (sc[4 * c] - dl[0]);
        sc[4 * c + 1] = p.y * (sc[4 * c + 1] - dl[0]);
        sc[4 * c + 2] = p.z * (sc[4 * c + 2] - dl[1]);
        sc[4 * c + 3] = p.w * (sc[4 * c + 3] - dl[1]);
        if constexpr (SCALED) {
          mx[0] = fmaxf(mx[0], fmaxf(fabsf(sc[4 * c]), fabsf(sc[4 * c + 1])));
          mx[1] = fmaxf(mx[1],
                        fmaxf(fabsf(sc[4 * c + 2]), fabsf(sc[4 * c + 3])));
        }
      }
      if constexpr (SCALED) {
        // each row's exponent, handed over beside dS; dQ's rows rescaled
        // where it fell; then dS times 2^e
        int en[2];
        float fs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          en[r] = ds_exponent(quad_max(mx[r]), ex[r]);
          fs[r] = pow2i(en[r]);
        }
        xe[tid] = make_int2(en[0], en[1]);
        rescale(en);
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * c + e] *= fs[e >> 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        acc_to_a<BN / 2, T>(dsa[kk], sc, kk);
        xds[kk * WG_THREADS + tid] =
            make_uint4(dsa[kk][0], dsa[kk][1], dsa[kk][2], dsa[kk][3]);
      }
      asm volatile("bar.arrive 4, 256;" ::: "memory");  // dS is out
    };
    // dQ[:, half] += dS·K[:, half] of the tile in kd, committed as one group
    auto issue_dq = [&]() {
      const uint64_t kdd = mnmajor_desc(kd + cw * (HW / 64) * BN * 64, BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HW, T>(acc, dsa[kk], kdd + mnmajor_step(kk));
      wgmma_commit();
    };

    if (cw == 1) row_deltas();
    for (int j = 0; j < n_k; ++j) {
      issue_scores(j);
      if (cw == 0) {
        p_out(j);
        ds_in();
      } else {
        ds_out();
      }
      mbar_wait(kd_full, j & 1);
      issue_dq();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(kd_empty);
    }

    if constexpr (SCALED)
      store_acc_rows<HW>(dq + head + c0 + cw * HW, acc, q0 + r_loc, Sq, rs,
                         pow2i(-ex[0]), pow2i(-ex[1]), t);
    else
      store_acc_rows<HW>(dq + head + c0 + cw * HW, acc, q0 + r_loc, Sq, rs,
                         1.f, 1.f, t);
    trap_if_stalled();
  }
}

template <int CW, typename T>
int launch_dq_chunked(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int H, int Sq, int Sk,
                      int D, int q_off, int causal, float scale,
                      cudaStream_t st) {
  using C = DqChunked<CW>;
  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dq_chunked_kernel<CW, T>),
        C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, D / CW, B * H);
  flash_dq_chunked_kernel<CW, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, D, q_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The chunked kernel on tensors of T at any D that is a multiple of 128,
// dQ's chunk 256 columns wide where D divides by 256.
template <typename T>
int dq_chunked(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               int B, int H, int Sq, int Sk, int D, int q_off, int causal,
               float scale, cudaStream_t st) {
  if (D % 256 == 0)
    return launch_dq_chunked<256, T>(q, k, v, o, dout, lse, delta, dq, B, H,
                                     Sq, Sk, D, q_off, causal, scale, st);
  return launch_dq_chunked<128, T>(q, k, v, o, dout, lse, delta, dq, B, H,
                                   Sq, Sk, D, q_off, causal, scale, st);
}

}  // namespace voda

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
// D = 256, 384, 512: flash_dq_wide_kernel; any multiple of 128 above 512:
// flash_dq_chunked_kernel.
extern "C" int voda_flash_dq_wide(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int B, int H, int Sq, int Sk, int D,
                                  int q_off, int causal, float scale,
                                  void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return dq_chunked<bf16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D,
                            q_off, causal, scale, st);
  return dq_wgmma<bf16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D,
                        q_off, causal, scale, st);
}

// fp16 tensors, the same arguments and the same kernels.
extern "C" int voda_flash_dq_f16_wide(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int H,
                                      int Sq, int Sk, int D, int q_off,
                                      int causal, float scale, void* stream) {
  using namespace voda;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 512)
    return dq_chunked<f16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D,
                           q_off, causal, scale, st);
  return dq_wgmma<f16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D,
                       q_off, causal, scale, st);
}
