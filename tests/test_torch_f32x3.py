"""The fp32 tensor-core kernels' arithmetic (``ops/csrc/flash_f32.cu``:
every fp32 product as three TF32 products, a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi), modelled in plain PyTorch (`tests/torch_f32x3_model.py`, at
each kernel's tiling and k-order, the forward's keys and dK/dV's queries in
the order PERM), against the JAX package's Pallas kernels in interpret mode
in fp32 and against the port's plain versions, on the CPU.

The bars are chip_smoke.py's `SIMT_LIMITS[float32]`, which hold the
kernels on the card: O, dK, dV row by row at 1e-4 (`row_err`), lse at 1e-4
absolute. The one-pass model (hi·hi alone, what the kernels compute if the
lo terms are dropped: scripts/torch_planted_fault.py's ``f32_one_pass``)
breaks them, so the bars tell the sound arithmetic from that fault. dK and
dV are held against the plain version computed in fp64 (its fp32 rounding
reads up to 1.8e-5 against its fp64 value on a single query's keys). The
card tests of the kernels against the same model are
`test_torch_cuda.py::test_fp32_tensor_core_kernels_match_their_model`.

Above D=128 the model takes the wide forward's tiling (``flash_f32.cu``:
``voda_flash_fwd_f32_wide``): S summed over D's 32-column chunks, O in
128-column chunks, 64-key tiles. It is held against the Pallas kernels at
D=256 and against the plain versions at D=384 and 640, at the same bars,
and the one-pass model and a model that leaves D's second chunk out of
every sum (the planted faults ``f32w_*`` of scripts/torch_planted_fault.py)
must break them. The card tests are
`test_torch_cuda.py::test_fp32_wide_kernels_match_their_model`.

K3 (``voda_flash_dkv_f32``, ``voda_flash_dkv_f32_wide``: one kernel at
every width) is modelled by `model.dkv`: Sᵀ and dPᵀ over 32-column chunks
of D, each chunk's passes summed apart, 64-row query tiles at D=64 and 32
from D=128, dK and dV in min(D, 128)-column chunks. Beside the cases above
it is held, at the dk_row and dv_row bars against the plain version in
fp64, on one query whose dSᵀ sums to zero over the keys (Sq = 1,
non-causal) and at Sq = 65; its one-pass model and a model that leaves D's
second chunk out of Sᵀ and dPᵀ break dk_row tenfold and dv_row beyond its
bar (the planted faults ``f32w_dkv_one_pass`` and ``f32w_dkv_drop_chunk``).

K2 (``voda_flash_dq_f32``, ``voda_flash_dq_f32_wide``: one kernel at every
width) has a model of its own, `model.dq`: S and dP over 32-column chunks
of D, each chunk's passes summed apart, 64-key tiles, dQ in
min(D, 128)-column chunks. It is held at the dq_row and δ bars against the
Pallas dQ kernel in interpret mode (D 64/128/256) and against the plain
version computed in fp64 (`chip_smoke.F32_DQ_ACC`, as chip_smoke.py holds
the kernel: a query row that sees one key has dP − δ cancel, and there the
plain version's own fp32 rounding reads near the bar at D=512), also at D
384, 512 and 640; the one-pass model and a model that leaves D's second
chunk out of S and dP must break dq_row more than tenfold (the planted
faults ``f32_dq_one_pass`` and ``f32_dq_drop_chunk``). The card tests are
`test_torch_cuda.py::test_fp32_dq_matches_its_model`.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.ops.flash_attention import _bwd as jax_bwd
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import flash_attention as fa

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
import torch_f32x3_model as model  # noqa: E402

LIMITS = chip_smoke.SIMT_LIMITS[torch.float32]
BLOCK = 64  # the Pallas kernels' blocks at these sizes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models run thousands of small products, each a parallel region
    of torch's thread pool: beside other test workers on the same cores the
    pool's threads wait on each other (the file took over 20 minutes on one
    of six workers, 77 s alone in one thread). One thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _pallas(q, k, v, do, causal, q_off):
    """(o, lse [B,H,Sq], dk, dv, dq) of the Pallas kernels in interpret
    mode, [B,S,H,D]."""
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o, lse = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    dq, dk, dv = jax_bwd(t(q), t(k), t(v), o, lse, t(do), off, causal,
                         BLOCK, BLOCK, True)
    B, H, Sq = q.shape[0], q.shape[2], q.shape[1]
    back = lambda x: torch.from_numpy(np.array(x)).transpose(1, 2)
    return (back(o), torch.from_numpy(np.asarray(
        lse[:, :, :, 0, :]).reshape(B, H, Sq)), back(dk), back(dv),
        back(dq))


def _model(q, k, v, do, causal, q_off, passes=3, drop_chunk=None):
    """(o, lse, dk, dv) of the model, K3 on the plain version's δ."""
    D = q.shape[-1]
    o, lse = model.fwd(q, k, v, causal, q_off, D ** -0.5, passes, drop_chunk)
    _, delta = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    dk, dv = model.dkv(q, k, v, do, lse, delta, causal, q_off, D ** -0.5,
                       passes, drop_chunk)
    return o, lse, dk, dv


def _errors(got, want) -> dict:
    o, lse, dk, dv = got
    o_w, lse_w, dk_w, dv_w = want
    return {"o_row": chip_smoke.row_err(o, o_w),
            "lse": (lse - lse_w).abs().max().item(),
            "dk_row": chip_smoke.row_err(dk, dk_w),
            "dv_row": chip_smoke.row_err(dv, dv_w)}


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    """10 stored mantissa bits: 1 + 2^-10 is kept, 1 + 2^-11 (a tie) goes
    up in magnitude, anything below the tie goes down; the split leaves
    less than 2^-21 of x."""
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                      -(1 + 2 ** -11), 3.0, 0.0])
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                         3.0, 0.0])
    assert torch.equal(model.tf32(x), want)
    assert torch.equal(model.tf32(x).view(torch.int32) & 0x1FFF,
                       torch.zeros(6, dtype=torch.int32))
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = model.split(y)
    assert ((y - hi - lo).abs() <= 2 ** -21 * y.abs()).all()
    assert sorted(model.perm_index(16).tolist()) == list(range(16))
    assert model.perm_index(8).tolist() == list(model.PERM)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 192, 192, 64, False, 0),
    (1, 2, 64, 192, 64, True, 128),      # a query slice behind an offset
    (1, 2, 128, 128, 128, True, 0),
    (1, 1, 128, 128, 128, False, 0),
    (1, 1, 64, 192, 128, True, 128),
    # the wide kernels' tiling
    (1, 2, 192, 192, 256, True, 0),
    (2, 1, 128, 192, 256, False, 0),
    (1, 2, 64, 256, 256, True, 192),
])
def test_three_passes_match_pallas_and_plain(B, H, Sq, Sk, D, causal, q_off):
    """The model of both kernels against the Pallas kernels in fp32 and
    against the port's plain versions, within SIMT_LIMITS[float32]."""
    q, k, v, do = _inputs(B, H, Sq, Sk, D, Sq + D)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    got = _model(qt, kt, vt, dot, causal, q_off)
    for want in (_plain(qt, kt, vt, dot, got, causal, q_off),
                 _pallas(q, k, v, do, causal, q_off)[:4]):
        errs = _errors(got, want)
        print("parity f32x3", B, H, Sq, Sk, D, causal, q_off, errs)
        assert all(errs[n] <= LIMITS[n] for n in errs), errs


def _plain(q, k, v, do, got, causal, q_off):
    """(o, lse, dk, dv) of the port's plain versions, K3 computed in fp64
    on the model's lse and the plain δ."""
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    _, delta = fa.flash_dq_reference(q, k, v, got[0], do, got[1], causal,
                                     q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, got[1], delta,
                                            causal, q_off, acc=torch.float64)
    return o_ref, lse_ref, dk_ref, dv_ref


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 160, 160, 384, True, 0),
    (1, 1, 96, 200, 384, False, 0),
    (1, 1, 130, 130, 640, True, 0),
    (1, 1, 64, 192, 640, True, 128),
])
def test_wide_tiling_matches_plain(B, H, Sq, Sk, D, causal, q_off):
    """The wide kernels' tiling at widths of three and five 128-column
    chunks of the output (D=384, 640) against the port's plain versions,
    within SIMT_LIMITS[float32]."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(B, H, Sq, Sk, D, Sq + D))
    got = _model(q, k, v, do, causal, q_off)
    errs = _errors(got, _plain(q, k, v, do, got, causal, q_off))
    print("parity f32x3 wide", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= LIMITS[n] for n in errs), errs


@pytest.mark.parametrize("D", [64, 128])
def test_one_pass_breaks_the_bars(D):
    """hi·hi alone keeps 11 bits of each operand: O, dK and dV each read
    above their bar against the plain versions, where three passes read
    below it (a causal head of 1024, as phase 3's cases)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 1024, 1024, D,
                                                        5))
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, 0)
    _, delta = fa.flash_dq_reference(q, k, v, o_ref, do, lse_ref, True, 0)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref, delta,
                                            True, 0)
    want = (o_ref, lse_ref, dk_ref, dv_ref)
    sound = _errors(_model(q, k, v, do, True, 0), want)
    one = _errors(_model(q, k, v, do, True, 0, passes=1), want)
    print("parity f32x3 one pass", D, sound, one)
    assert all(sound[n] <= LIMITS[n] for n in sound), sound
    for n in ("o_row", "dk_row", "dv_row"):
        assert one[n] > LIMITS[n], (n, one)


@pytest.mark.parametrize("fault", ["one_pass", "drop_chunk"])
def test_wide_faults_break_the_bars(fault):
    """At D=256 (a causal head of 1024, as phase 3's cases): the one-pass
    model (hi·hi alone) and a model whose S, Sᵀ and dPᵀ leave D's second
    32-column chunk out read above the bars on O, dK and dV, where the sound
    model reads below them. dK/dV's fault alone (on the sound forward's
    lse) breaks dK and dV, the forward's alone O."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 1024, 1024,
                                                        256, 6))
    kw = {"passes": 1} if fault == "one_pass" else {"drop_chunk": 1}
    want = _plain(q, k, v, do, _model(q, k, v, do, True, 0), True, 0)
    sound = _errors(_model(q, k, v, do, True, 0), want)
    assert all(sound[n] <= LIMITS[n] for n in sound), sound
    D, scale = 256, 256 ** -0.5
    o, lse = model.fwd(q, k, v, True, 0, scale, **kw)
    fwd_alone = _errors((o, lse, want[2], want[3]), want)
    _, delta = fa.flash_dq_reference(q, k, v, want[0], do, want[1], True, 0)
    dk, dv = model.dkv(q, k, v, do, want[1], delta, True, 0, scale, **kw)
    dkv_alone = _errors((want[0], want[1], dk, dv), want)
    print("parity f32x3 wide fault", fault, sound, fwd_alone, dkv_alone)
    assert fwd_alone["o_row"] > LIMITS["o_row"], fwd_alone
    for n in ("dk_row", "dv_row"):
        assert dkv_alone[n] > LIMITS[n], (n, dkv_alone)


def _dq_errors(q, k, v, o, do, lse, causal, q_off, **fault) -> dict:
    """dq_row and δ of K2's model (`fault`: passes=1 or drop_chunk=1)
    against the plain version computed in fp64, on the given o and lse."""
    D = q.shape[-1]
    dq, delta = model.dq(q, k, v, o, do, lse, causal, q_off, D ** -0.5,
                         **fault)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off, acc=chip_smoke.F32_DQ_ACC)
    return {"dq_row": chip_smoke.row_err(dq, dq_ref),
            "delta": (delta - delta_ref).abs().max().item()}


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 192, 192, 64, False, 0),
    (1, 2, 64, 192, 64, True, 128),      # a query slice behind an offset
    (1, 2, 128, 128, 128, True, 0),
    (1, 1, 128, 128, 128, False, 0),
    (1, 1, 64, 192, 128, True, 128),
    (1, 2, 192, 192, 256, True, 0),
    (2, 1, 128, 192, 256, False, 0),
    (1, 2, 64, 256, 256, True, 192),
])
def test_dq_three_passes_match_pallas_and_plain(B, H, Sq, Sk, D, causal,
                                                q_off):
    """K2's model on the Pallas forward's O and lse against the Pallas dQ
    kernel in fp32 and against the plain version in fp64, within
    SIMT_LIMITS[float32] (dq_row; δ against the plain version's)."""
    q, k, v, do = _inputs(B, H, Sq, Sk, D, Sq + D + 1)
    o, lse, _, _, dq_pallas = _pallas(q, k, v, do, causal, q_off)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    errs = _dq_errors(qt, kt, vt, o, dot, lse, causal, q_off)
    dq, _ = model.dq(qt, kt, vt, o, dot, lse, causal, q_off, D ** -0.5)
    errs["dq_row_pallas"] = chip_smoke.row_err(dq, dq_pallas)
    print("parity f32x3 dq", B, H, Sq, Sk, D, causal, q_off, errs)
    assert errs["dq_row"] <= LIMITS["dq_row"], errs
    assert errs["dq_row_pallas"] <= LIMITS["dq_row"], errs
    assert errs["delta"] <= LIMITS["delta"], errs


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 160, 160, 384, True, 0),
    (1, 1, 96, 200, 384, False, 0),
    (1, 1, 130, 130, 640, True, 0),
    (1, 1, 64, 192, 640, True, 128),
])
def test_dq_wide_tiling_matches_plain(B, H, Sq, Sk, D, causal, q_off):
    """K2's model at widths of three and five 128-column chunks of dQ
    (D=384, 640: each CTA of a row block sums the same S and dP over every
    chunk of D) against the plain version in fp64, within
    SIMT_LIMITS[float32]."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(B, H, Sq, Sk, D, Sq + D + 1))
    o, lse = fa.flash_attention_reference(q, k, v, causal, q_off)
    errs = _dq_errors(q, k, v, o, do, lse, causal, q_off)
    print("parity f32x3 dq wide", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= LIMITS[n] for n in errs), errs


@pytest.mark.parametrize("D", [64, 512])
def test_dq_holds_the_rows_whose_dp_and_delta_cancel(D):
    """A causal head from position 0: the first query sees one key, so P =
    1, O = V's first row and dP − δ = dO·(v₀ − o₀) cancels to rounding;
    dQ's row is near 0 and `row_err` holds it to 1e-3 of the largest row.
    The model reads within the bar there against the plain version in
    fp64 (the plain version in fp32, printed beside, carries its own
    rounding of that cancellation)."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(1, 2, 512, 512, D, 8))
    o, lse = fa.flash_attention_reference(q, k, v, True, 0)
    ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0,
                                acc=chip_smoke.F32_DQ_ACC)[0]
    norms = ref.norm(dim=-1)
    assert (norms[:, 0] < 1e-3 * norms.max()).all()  # the cancelling row
    errs = _dq_errors(q, k, v, o, do, lse, True, 0)
    fp32 = chip_smoke.row_err(
        fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)[0], ref)
    print("parity f32x3 dq cancelling", D, errs, "plain fp32", fp32)
    assert all(errs[n] <= LIMITS[n] for n in errs), errs


@pytest.mark.parametrize("fault", ["one_pass", "drop_chunk"])
@pytest.mark.parametrize("D", [64, 256])
def test_dq_faults_break_the_bar_tenfold(fault, D):
    """A causal head of 1024, as phase 3's cases: K2's one-pass model
    (hi·hi alone in S, dP and dS·K) and a model whose S and dP leave D's
    second 32-column chunk out read dq_row above ten times its bar, where
    the sound model reads below the bar. δ is the kernel's own sum, untouched
    by either fault."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(1, 2, 1024, 1024, D, 7))
    o, lse = fa.flash_attention_reference(q, k, v, True, 0)
    sound = _dq_errors(q, k, v, o, do, lse, True, 0)
    kw = {"passes": 1} if fault == "one_pass" else {"drop_chunk": 1}
    faulty = _dq_errors(q, k, v, o, do, lse, True, 0, **kw)
    print("parity f32x3 dq fault", fault, D, sound, faulty)
    assert all(sound[n] <= LIMITS[n] for n in sound), sound
    assert faulty["dq_row"] > 10 * LIMITS["dq_row"], faulty
    assert faulty["delta"] == sound["delta"]


def _dkv_errors(q, k, v, do, causal, q_off, **fault) -> dict:
    """dk_row and dv_row of K3's model (`fault`: passes=1 or drop_chunk=1)
    against the plain version computed in fp64, on the plain forward's lse
    and the plain δ."""
    D = q.shape[-1]
    o, lse = fa.flash_attention_reference(q, k, v, causal, q_off)
    _, delta = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    dk, dv = model.dkv(q, k, v, do, lse, delta, causal, q_off, D ** -0.5,
                       **fault)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off, acc=torch.float64)
    return {"dk_row": chip_smoke.row_err(dk, dk_ref),
            "dv_row": chip_smoke.row_err(dv, dv_ref)}


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (2, 2, 1, 64, 64, False, 0),      # one query: Σ over the keys of dSᵀ is 0
    (2, 2, 1, 200, 256, False, 0),
    (1, 2, 65, 65, 64, True, 0),      # Sq = 65: a tile of one row
    (2, 1, 65, 65, 384, True, 0),
])
def test_dkv_holds_one_query_and_a_ragged_tile(B, H, Sq, Sk, D, causal,
                                               q_off):
    """K3's model on a single query (dSᵀ = P∘(dP − δ)·scale, whose sum over
    the keys cancels: δ is P's weighted dP) and at Sq = 65, where the last
    query tile holds one row, the rest TMA's zeros, masked: within the
    dk_row and dv_row bars of the plain version in fp64."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(B, H, Sq, Sk, D, Sq + D + 2))
    errs = _dkv_errors(q, k, v, do, causal, q_off)
    print("parity f32x3 dkv edge", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= LIMITS[n] for n in errs), errs


@pytest.mark.parametrize("fault", ["one_pass", "drop_chunk"])
@pytest.mark.parametrize("D", [64, 256])
def test_dkv_faults_break_the_bars(fault, D):
    """A causal head of 1024, as phase 3's cases: K3's one-pass model (hi·hi
    alone in Sᵀ, dPᵀ, dV and dK) and a model whose Sᵀ and dPᵀ leave D's
    second 32-column chunk out read dk_row above ten times its bar and
    dv_row above its bar (one pass: dk_row 1.7e-3 to 1.9e-3, dv_row 1.0e-3
    to 1.2e-3; the dropped chunk above 0.6), where the sound model reads
    below both against the plain version in fp64."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(1, 2, 1024, 1024, D, 7))
    sound = _dkv_errors(q, k, v, do, True, 0)
    kw = {"passes": 1} if fault == "one_pass" else {"drop_chunk": 1}
    faulty = _dkv_errors(q, k, v, do, True, 0, **kw)
    print("parity f32x3 dkv fault", fault, D, sound, faulty)
    assert all(sound[n] <= LIMITS[n] for n in sound), sound
    assert faulty["dk_row"] > 10 * LIMITS["dk_row"], faulty
    assert faulty["dv_row"] > LIMITS["dv_row"], faulty
