"""The port's MoE dispatch against the JAX package's, on the CPU.

- Routing, exact: `top_k_gating` keeps the same experts as the reference
  (and `top_k_indices` orders them as `lax.top_k`) on random, all-tied and
  pairwise-tied probabilities and on a row whose top two differ by 1e-7;
  `expert_capacity` gives the same slots on a grid; `_slot_positions` and
  `route` give the same slots, drops, dispatch and combine at capacity
  factors 100 (nothing drops) and 0.5 (tokens drop).
- The MoE block under each dispatch (routed, gather, dense) on the same
  weights and fp32 input: output and the gradients of x, the router and
  the three expert weights. Expert compute is bf16 in both packages, and
  the two round bf16 products and SwiGLU's elementwise steps differently,
  so the bar is bf16's: max |err| ≤ 2e-2 · max |ref| for each tensor. The
  smallest gap between the k-th and (k+1)-th router probability of the
  inputs exceeds 1e-4, so both packages route every token alike.
- The port's gather equals its routed dispatch, at generous and tight
  capacity, at the reference's own bar for the pair (1e-2 abs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.models import mixtral as jmixtral
from vodascheduler_tpu.ops import moe_dispatch as jmoe
from vodascheduler_tpu_torch.models import mixtral as tmixtral
from vodascheduler_tpu_torch.ops import moe_dispatch as tmoe

from tests.torch_parity import assert_close

BF16_SHARE = 2e-2
D, E, H, K = 64, 4, 128, 2


def _softmax(logits):
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def _probs(case):
    rng = np.random.default_rng(0)
    if case == "random":
        return _softmax(rng.standard_normal((4, 16, 8)).astype(np.float32))
    if case == "all_tied":
        return np.full((3, 4), 0.25, np.float32)
    if case == "pairwise_tied":
        rows = [[0.3, 0.3, 0.2, 0.2], [0.2, 0.3, 0.2, 0.3],
                [0.2, 0.2, 0.3, 0.3], [0.4, 0.2, 0.2, 0.2],
                [0.1, 0.4, 0.1, 0.4]]
        return np.asarray(rows, np.float32)
    # the top two (and the next two) differ by 1e-7
    return np.asarray([[0.25 - 1e-7, 0.25 + 1e-7, 0.25, 0.25],
                       [0.25, 0.25, 0.25 + 1e-7, 0.25 - 1e-7]], np.float32)


@pytest.mark.parametrize("case", ["random", "all_tied", "pairwise_tied",
                                  "gap_1e-7"])
def test_top_k_gating_keeps_the_reference_experts(case):
    probs = _probs(case)
    ref = np.asarray(jmoe.top_k_gating(jnp.asarray(probs), K))
    got = tmoe.top_k_gating(torch.tensor(probs), K).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0, err_msg=case)
    assert ((got > 0).sum(-1) == K).all()
    assert_close(f"top_k_gating {case}", got, ref, atol=1e-7, rtol=1e-6)
    _, ref_idx = jax.lax.top_k(jnp.asarray(probs), K)
    np.testing.assert_array_equal(
        tmoe.top_k_indices(torch.tensor(probs), K).numpy(),
        np.asarray(ref_idx), err_msg=case)


def test_expert_capacity_matches_the_reference():
    for T in (1, 7, 16, 64, 1000, 1024, 16384):
        for experts in (1, 4, 8):
            for k in (1, 2):
                for factor in (0.5, 1.0, 1.25, 100.0):
                    args = (T, experts, k, factor)
                    assert (tmoe.expert_capacity(*args)
                            == jmoe.expert_capacity(*args)), args
    assert tmoe.expert_capacity(1024, 8, 2, 1.25) == 320
    assert tmoe.expert_capacity(16384, 8, 2, 1.25) == 5120  # mixtral_small
    assert tmoe.expert_capacity(16, 4, 2, 100.0) == 16      # capped at T
    assert tmoe.expert_capacity(4, 8, 1, 0.5) == 4          # 8, capped


def _gates(T=64, seed=1):
    probs = _softmax(np.random.default_rng(seed).standard_normal(
        (T, E)).astype(np.float32))
    return np.asarray(jmoe.top_k_gating(jnp.asarray(probs), K))


@pytest.mark.parametrize("factor", [100.0, 0.5])
def test_slots_and_route_match_the_reference(factor):
    gates = _gates()
    capacity = jmoe.expert_capacity(gates.shape[0], E, K, factor)
    pos_ref, kept_ref = jmoe._slot_positions(jnp.asarray(gates), capacity)
    pos, kept = tmoe._slot_positions(torch.tensor(gates), capacity)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_ref))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_ref))
    routed = int((gates > 0).sum())
    dropped = routed - int(kept.sum())
    assert (dropped == 0) if factor == 100.0 else (dropped > 0)
    disp_ref, comb_ref = jmoe.route(jnp.asarray(gates), capacity)
    disp, comb = tmoe.route(torch.tensor(gates), capacity)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_ref))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(comb_ref))
    share = tmoe.dropped_share(torch.tensor(gates)[None], factor, K)
    assert share == pytest.approx(dropped / routed)


def _block_inputs(seed=2):
    rng = np.random.default_rng(seed)
    w = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)),
         "experts_gate_kernel": rng.standard_normal((E, D, H)) / np.sqrt(D),
         "experts_up_kernel": rng.standard_normal((E, D, H)) / np.sqrt(D),
         "experts_down_kernel": rng.standard_normal((E, H, D)) / np.sqrt(H)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    w_out = rng.standard_normal((2, 16, D)).astype(np.float32)
    # every token's k-th and (k+1)-th probability apart: both packages
    # route alike
    p = np.sort(_softmax((x.reshape(-1, D) @ w["router"]).astype(np.float64)),
                -1)[:, ::-1]
    assert (p[:, K - 1] - p[:, K]).min() > 1e-4
    return w, x, w_out


def _port_block(dispatch, factor, w):
    cfg = dataclasses.replace(tmixtral.MIXTRAL_TINY, dispatch=dispatch,
                              capacity_factor=factor)
    block = tmixtral.MoEBlock(cfg)
    block.load_state_dict({
        "router.weight": torch.tensor(w["router"].T.copy()),
        **{n: torch.tensor(w[n]) for n in
           ("experts_gate_kernel", "experts_up_kernel",
            "experts_down_kernel")}})
    return block


@pytest.mark.parametrize("dispatch", ["routed", "gather", "dense"])
def test_moe_block_matches_the_reference(dispatch):
    w, x, w_out = _block_inputs()
    cfg = dataclasses.replace(jmixtral.MIXTRAL_TINY, dispatch=dispatch)
    block = jmixtral.MoEBlock(cfg)
    params = {"router": {"kernel": w["router"]},
              **{n: w[n] for n in ("experts_gate_kernel",
                                   "experts_up_kernel",
                                   "experts_down_kernel")}}

    def f(p, x):
        return (block.apply({"params": p}, x) * w_out).sum()

    out_ref = block.apply({"params": params}, x)
    g_ref, gx_ref = jax.grad(f, argnums=(0, 1))(params, x)

    mod = _port_block(dispatch, cfg.capacity_factor, w)
    xt = torch.tensor(x, requires_grad=True)
    out = mod(xt)
    (out * torch.tensor(w_out)).sum().backward()
    pairs = [("out", out, out_ref), ("dx", xt.grad, gx_ref),
             ("d_router", mod.router.weight.grad.T, g_ref["router"]["kernel"])]
    pairs += [(f"d_{n}", getattr(mod, n).grad, g_ref[n])
              for n in ("experts_gate_kernel", "experts_up_kernel",
                        "experts_down_kernel")]
    for name, got, ref in pairs:
        scale = float(np.abs(np.asarray(ref)).max())
        assert scale > 0, name
        assert_close(f"moe block {dispatch} {name}", got, ref,
                     atol=BF16_SHARE * scale, rtol=0)


@pytest.mark.parametrize("factor", [100.0, 0.5])
def test_port_gather_equals_port_routed(factor):
    w, x, _ = _block_inputs()
    xt = torch.tensor(x)
    with torch.no_grad():
        routed = _port_block("routed", factor, w)(xt)
        gather = _port_block("gather", factor, w)(xt)
    assert torch.isfinite(gather).all()
    assert_close(f"port gather vs routed, capacity factor {factor}", gather,
                 routed, atol=1e-2, rtol=0)


def test_unknown_dispatch_is_refused():
    cfg = dataclasses.replace(tmixtral.MIXTRAL_TINY, dispatch="gathered")
    with pytest.raises(ValueError, match="'gathered'"):
        tmixtral.MoEBlock(cfg)
