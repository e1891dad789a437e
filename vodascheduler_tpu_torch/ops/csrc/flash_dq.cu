// K2: flash-attention dQ for Hopper (sm_90a).
//
// Replaces `_dq_kernel` in vodascheduler_tpu/ops/flash_attention.py
// (launched in `_bwd`): dQ = Σⱼ dS·K with P = exp(S − lse) recomputed from
// S = Q·Kᵀ·D^-½, dS = P∘(dO·Vᵀ − δ)·D^-½ and δ = rowsum(dO∘O). δ is written
// to `delta` [B, H, Sq] once per row: the dK/dV kernel (flash_dkv.cu),
// launched after this one on the same stream, reads it.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): three products (Q·Kᵀ,
// dO·Vᵀ, dS·K), halved under the causal mask: 103 GFLOP, 104 µs at B=8,
// H=16, S=2048, D=64, against ≈ 6·33.6 MB + 2·1 MB of bytes, 61 µs:
// compute-bound, so the design is about keeping the tensor cores fed.
//
// Design. One CTA owns 128 query rows of one (b, h): a producer warpgroup,
// of which one thread issues every TMA load, and two consumer warpgroups of
// 64 rows each, as in the forward (flash_fwd.cu).
// - Q, dO and O of the tile arrive once by TMA; K and V tiles of BN keys
//   pass through a ring of STAGES stages, each guarded by a "full" mbarrier
//   per operand (K and V apart) and one "empty" mbarrier that the 256
//   consumer threads arrive on once dQ += dS·K, the stage's last reader, is
//   done. The loads of the next tiles run under the products of this one.
// - δ: a thread sums dO∘O over a quarter of each of its two rows straight
//   from the swizzled tiles and finishes across its quad. dO and O share
//   one swizzle, which only permutes a row's 16-byte chunks within the row,
//   so the row sum needs no unswizzling. O is read for nothing else.
// - S = Q·Kᵀ and dP = dO·Vᵀ are wgmma m64nBNk16 with both operands K-major
//   in shared memory. P and dS are computed on the accumulators and packed
//   to bf16 A fragments of dQ += dS·K, whose B = K is read MN-major from the
//   same swizzled stage through the transpose bit. S, P and dS never leave
//   registers. D^-½ rides in the exponent: lse is staged as
//   lse·log2e − log2 D^-½, so exp2(S·D^-½·log2e − that) = P·D^-½ and dS
//   comes out scaled before its cast to bf16, as in the reference, at no
//   cost per element and with the reference's rounding at every D.
// - Overlap, at D=64: a warpgroup issues S and dP of tile j together with
//   dQ of tile j−1 and computes dS of tile j while dQ runs; the two
//   warpgroups take turns at issuing (Turns in hopper.cuh), so one's dS
//   runs under the other's products. At D=128 the overlap made ptxas
//   spill; the warpgroups go tile by tile, each product waited for, and
//   the other warpgroup fills the gaps.
// - Causal: K/V tiles past the last row's diagonal are never loaded
//   (q_off + last row ≥ j·BN), only tiles that cross the diagonal or the
//   ragged end of Sk are masked, and the query tile is the grid's fastest
//   axis, reversed: the long tiles of each head start first and the CTAs in
//   flight together share a few heads' K/V in L2.
// - Tiles: 64 keys. A consumer then holds S and dP (32 fp32 each), dS as
//   A fragments (16) and dQ (32 at D=64, 64 at D=128) registers; ptxas
//   keeps them in flight without a spill. Three stages: Q, dO, O 48 KB +
//   3 × 16 KB at D=64, 96 KB + 3 × 32 KB at D=128, of the 227 KB.
// - Rows past Sq arrive from TMA as zeros, take lse 0 and are never
//   stored; keys past Sk arrive as zeros and are masked.
//
// No atomics: each CTA writes its own rows of dQ and δ, so both are
// deterministic.
//
// fp16 (voda_flash_dq_f16). The same kernel on fp16 tensors, through
// wgmma's f16 form (the element type is a template parameter), with one
// change. `_dq_kernel` rounds dS to the input dtype before dQ = dS·K
// (`ds.astype(k.dtype)`); in fp16 that flushes the dS of an unscaled loss
// (an output gradient of 1e-6 gives dS near 1e-8, below fp16's smallest
// normal, 6e-5), and wgmma takes both operands in one type, so dS cannot
// stay fp32. So each query row i of dS is rounded to fp16 under a
// power-of-two scale 2^e_i, as flash_dkv.cu does for the key rows of dSᵀ:
// - e_i is a running exponent, one for each of the thread's two rows (the
//   same rows in dS and in dQ's accumulator), E_MAX at the start;
// - each key tile takes the row's max |dS| over the quad that holds it and
//   the exponent that puts that max in [2^13, 2^14) (DS_TOP, ds_exponent in
//   hopper.cuh), lowered to it where that is below e_i; a row with no
//   nonzero dS in the tile (masked) keeps its exponent. dS is multiplied by
//   2^e_i before it is packed to fp16 A fragments;
// - where e_i fell, the row of dQ's accumulator is multiplied by
//   2^(new − old) (exact in fp32), behind a warp vote, once the last tile's
//   dQ product is in and before this tile's is issued (`pack_ds`). At D=64
//   the exponents come out of dS of tile j, computed under dQ of tile j−1,
//   and the rescale waits for that product's wgmma_wait<0>, which no branch
//   surrounds;
// - the epilogue stores dQ's row times 2^-e_i.
// For bf16 none of this is compiled (`if constexpr`).

#include "hopper.cuh"

namespace voda {

template <int D>
struct Dq {
  static constexpr int BM = 128;  // query rows of a CTA
  // Keys of a K/V tile. With 128 keys S, dP (64 fp32 each), dS (32) and dQ
  // (32 at D=64) in flight together made ptxas spill 1636 bytes and
  // serialise the wgmma at D=64, 2.2x slower (scripts/torch_kernel_ablate.py
  // on an H100).
  static constexpr int BN = 64;
  static constexpr int STAGES = 3;
  // At D=64: S, dP of tile j issued with dQ of tile j−1, under the
  // warpgroups' turns at issuing. At D=128 dQ is 32 registers more and
  // the overlap spilled 80 bytes, so D=128 goes tile by tile.
  static constexpr bool OVERLAP = D == 64;
  static constexpr int T_BYTES = BM * D * 2;  // each of Q, dO, O
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int DO_OFF = T_BYTES;
  static constexpr int O_OFF = 2 * T_BYTES;
  static constexpr int K_OFF = 3 * T_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; 1 KB of slack to
  // align the base to the 1024 bytes of the swizzle
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

// δ of row r of the swizzled [BM, D] tiles dO and O: thread t of the quad
// takes the chunks t and t + 4 of every 64-column part, in an order that
// puts the 8 threads of one 16-byte load phase (two rows) on distinct
// banks, and the quad sums.
template <int BM, int D, typename T>
__device__ __forceinline__ float row_delta(const T* dos, const T* os, int r,
                                           int g, int t) {
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int off = p * BM * 64 + r * 64 + (((t + 4 * x) ^ (4 * (g & 1))) * 8);
      s += dot8<T>(*reinterpret_cast<const uint4*>(dos + off),
                   *reinterpret_cast<const uint4*>(os + off));
    }
  }
  return quad_sum(s);
}

// P·D^-½ and dS of one tile on its accumulators, in place: sc holds
// S = Q·Kᵀ (unscaled), dp holds dP = dO·Vᵀ and takes dS = P∘(dP − δ)·D^-½.
// lse2 is a row's lse·log2e − log2 D^-½, so exp2(S·sl2 − lse2) = P·D^-½.
// SCALED (fp16): mx takes the largest |dS| of each of the thread's rows.
template <int BN, bool SCALED>
__device__ __forceinline__ void ds_tile(float (&sc)[BN / 2], float (&dp)[BN / 2],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], float sl2,
                                        bool masked, int col0, int Sk,
                                        int causal, const int (&row)[2], int t,
                                        float (&mx)[2]) {
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
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * c + e], sl2, -lse2[e >> 1]));
      dp[4 * c + e] = p * (dp[4 * c + e] - dl[e >> 1]);
      if constexpr (SCALED) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(dp[4 * c + e]));
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Sq, int Sk, int q_off,
                    int causal, float scale) {
  using C = Dq<D>;
  // fp16: dS under a per-query-row scale (header)
  constexpr bool SCALED = std::is_same<T, f16>::value;
  using Regs = RegSplit<24, 240>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* qs = reinterpret_cast<T*>(sm);
  T* dos = reinterpret_cast<T*>(sm + C::DO_OFF);
  T* os = reinterpret_cast<T*>(sm + C::O_OFF);
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
      mbar_expect_tx(q_full, 3 * C::T_BYTES);
      tma_rows<D>(qs, &tq, q_full, C::BM, h, q0, b);
      tma_rows<D>(dos, &tdo, q_full, C::BM, h, q0, b);
      tma_rows<D>(os, &to, q_full, C::BM, h, q0, b);
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
    // ---- consumers: 64 query rows per warpgroup. At D=64, while the
    // tensor cores run dQ += dS·K of tile j−1, the warpgroup computes dS of
    // tile j, whose S and dP were issued just before.
    Regs::consumer();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_loc = cw * 64 + warp * 16 + g;   // the thread's first row
    const int row[2] = {q_off + q0 + r_loc, q_off + q0 + r_loc + 8};
    const int wg_row0 = q_off + q0 + cw * 64;    // the warpgroup's first row
    const float sl2 = scale * LOG2E;
    const size_t stat = (static_cast<size_t>(b) * H + h) * Sq;

    // lse of the thread's rows, read under the TMA loads; 0 past Sq
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = q0 + r_loc + 8 * r;
      lse2[r] = gr < Sq ? fmaf(lse[stat + gr], LOG2E, -log2f(scale)) : 0.f;
    }

    mbar_wait(q_full, 0);
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] = row_delta<C::BM, D>(dos, os, r_loc + 8 * r, g, t);
      if (t == 0 && q0 + r_loc + 8 * r < Sq) delta[stat + q0 + r_loc + 8 * r] = dl[r];
    }

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float sc[C::BN / 2], dp[C::BN / 2];
    uint32_t dsa[C::BN / 16][4];
    // fp16: the exponents of the thread's two rows, and those of the tile
    // whose dS was formed last (header)
    int ex[2] = {E_MAX, E_MAX}, en[2] = {E_MAX, E_MAX};

    // S = Q·Kᵀ and dP = dO·Vᵀ of tile j, committed as one group. Both
    // barriers are waited for before the first wgmma: a wait between two
    // wgmma makes ptxas serialise them.
    auto issue_sdp = [&](int j) {
      const int s = j % C::STAGES;
      const uint32_t ph = (j / C::STAGES) & 1;
      mbar_wait(&k_full[s], ph);
      mbar_wait(&v_full[s], ph);
      const uint64_t qd = kmajor_desc(qs, cw * 64);
      const uint64_t dd = kmajor_desc(dos, cw * 64);
      const uint64_t kd = kmajor_desc(ks + s * C::BN * D, 0);
      const uint64_t vd = kmajor_desc(vs + s * C::BN * D, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BN, T>(sc, qd + kmajor_step(C::BM, kk),
                           kd + kmajor_step(C::BN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BN, T>(dp, dd + kmajor_step(C::BM, kk),
                           vd + kmajor_step(C::BN, kk), kk > 0);
      wgmma_commit();
    };
    // dQ += dS·K of tile j, committed as one group
    auto issue_dq = [&](int j) {
      const int s = j % C::STAGES;
      const uint64_t kd = mnmajor_desc(ks + s * C::BN * D, C::BN);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        wgmma_rs<D, T>(acc, dsa[kk], kd + mnmajor_step(kk));
      wgmma_commit();
    };
    auto p_ds = [&](int j) {
      fence_regs(sc);
      fence_regs(dp);
      const bool masked = (j + 1) * C::BN > Sk ||
                          (causal && j * C::BN + C::BN - 1 > wg_row0);
      float mx[2] = {0.f, 0.f};
      ds_tile<C::BN, SCALED>(sc, dp, lse2, dl, sl2, masked, j * C::BN, Sk,
                             causal, row, t, mx);
      if constexpr (SCALED) {
        // each row's exponent for the tile, and dS times 2^e
#pragma unroll
        for (int r = 0; r < 2; ++r)
          en[r] = ds_exponent(quad_max(mx[r]), ex[r]);
        const float fs[2] = {pow2i(en[0]), pow2i(en[1])};
#pragma unroll
        for (int e = 0; e < C::BN / 2; ++e) dp[e] *= fs[(e >> 1) & 1];
      }
    };
    // dS into A fragments; fp16: dQ's rows first rescaled where an exponent
    // fell, so dQ's last product must be in
    auto pack_ds = [&] {
      if constexpr (SCALED) {
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
          for (int e = 0; e < D / 2; ++e) acc[e] *= f[(e >> 1) & 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        acc_to_a<C::BN / 2, T>(dsa[kk], dp, kk);
    };

    const Turns<C::OVERLAP> turns{cw};
    if (n_k > 0 && !C::OVERLAP) {
      // tile by tile: S and dP, then dS, then dQ, each product waited for
      for (int j = 0; j < n_k; ++j) {
        issue_sdp(j);
        wgmma_wait<0>();
        p_ds(j);
        pack_ds();
        issue_dq(j);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[j % C::STAGES]);
      }
    } else if (n_k > 0) {
      // S and dP of tile j issued with dQ of tile j−1, dS of tile j
      // computed under dQ; the last tile's dQ is peeled
      turns.start_kernel();
      turns.begin();
      issue_sdp(0);
      turns.end(false);
      wgmma_wait<0>();
      p_ds(0);
      pack_ds();
      for (int j = 1; j < n_k; ++j) {
        turns.begin();
        issue_sdp(j);
        issue_dq(j - 1);
        turns.end(false);
        wgmma_wait<1>();   // S and dP of tile j are in
        p_ds(j);
        wgmma_wait<0>();   // dQ of tile j−1 is in
        fence_regs(acc);
        mbar_arrive(&empty[(j - 1) % C::STAGES]);
        pack_ds();
      }
      turns.begin();
      issue_dq(n_k - 1);
      turns.end(true);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(n_k - 1) % C::STAGES]);
    }

    T* dq_head = dq + (static_cast<size_t>(b) * Sq * H + h) * D;
    if constexpr (SCALED)
      store_acc_rows<D>(dq_head, acc, q0 + r_loc, Sq, H * D, pow2i(-ex[0]),
                        pow2i(-ex[1]), t);
    else
      store_acc_rows<D>(dq_head, acc, q0 + r_loc, Sq, H * D, 1.f, 1.f, t);
    trap_if_stalled();
  }
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B,
              int H, int Sq, int Sk, int q_off, int causal, float scale,
              cudaStream_t st) {
  using C = Dq<D>;
  CUtensorMap tq, tk, tv, to, tdo;
  const CUtensorMapDataType ty = tma_type<T>();
  int err = make_rows_map(&tq, q, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tk, k, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&tv, v, B, Sk, H, D, C::BN, ty);
  if (!err) err = make_rows_map(&to, o, B, Sq, H, D, C::BM, ty);
  if (!err) err = make_rows_map(&tdo, dout, B, Sq, H, D, C::BM, ty);
  if (!err)
    err = prepare_ws_kernel(
        reinterpret_cast<const void*>(&flash_dq_kernel<D, T>), C::SMEM);
  if (err) return err;
  const dim3 grid((Sq + C::BM - 1) / C::BM, H, B);
  flash_dq_kernel<D, T><<<grid, WS_THREADS, C::SMEM, st>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), H, Sq, Sk, q_off,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Returns 0, or the error of the tensor-map encoding, the kernel's set-up or
// its launch; 1 (cudaErrorInvalidValue) for a head_dim without an
// instantiation.
template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* delta, void* dq, int B, int H,
       int Sq, int Sk, int D, int q_off, int causal, float scale,
       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64, T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk,
                            q_off, causal, scale, st);
  if (D == 128)
    return launch_dq<128, T>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk,
                             q_off, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace voda

// bf16 and fp16 tensors, the same arguments.
extern "C" int voda_flash_dq(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, int B, int H, int Sq,
                             int Sk, int D, int q_off, int causal, float scale,
                             void* stream) {
  return voda::run_dq<voda::bf16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq,
                                  Sk, D, q_off, causal, scale, stream);
}

extern "C" int voda_flash_dq_f16(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int B,
                                 int H, int Sq, int Sk, int D, int q_off,
                                 int causal, float scale, void* stream) {
  return voda::run_dq<voda::f16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq,
                                 Sk, D, q_off, causal, scale, stream);
}
