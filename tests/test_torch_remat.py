"""The selective remat policies of the port against the JAX package's.

For each policy of REMAT_POLICIES (None, "dots", "attn_out",
"dots_attn"), a scanned LLAMA_TINY with remat gives the JAX model's loss
and every gradient at 1e-5, on the same bridged weights and numpy batch, in
fp32 on the CPU. The port's attention goes through its flash-attention
operator (its plain version on the CPU), the operator a policy saves.

What each policy keeps is counted in the backward: the attention forward
runs again in the recompute unless the policy saves its output ("attn_out",
"dots_attn"), and the matrix products of the forward run again unless it
saves them ("dots", "dots_attn").
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import layers as tl
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.ops import flash_attention as fa

from tests.torch_parity import assert_close

POLICIES = [None, "dots", "attn_out", "dots_attn"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(policy):
    kw = dict(dtype="float32", remat_layers=True, remat_policy=policy)
    return (dataclasses.replace(jllama.LLAMA_TINY_SCAN, **kw),
            dataclasses.replace(tllama.LLAMA_TINY_SCAN, **kw))


def _batch():
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 256, (2, 16)).astype(np.int32)
    return tokens, targets


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy):
    jcfg, tcfg = _configs(policy)
    model = jllama.Llama(jcfg)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens, targets = _batch()
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: model.apply({"params": p}, tokens, targets=targets))(params)

    mod = tllama.Llama(tcfg)
    mod.load_state_dict(bridge.flax_to_state_dict(params))
    mod.attn_fn = functools.partial(fa.flash_attention, causal=True)
    loss = mod(torch.tensor(tokens).long(),
               targets=torch.tensor(targets).long())
    loss.backward()
    assert_close(f"remat {policy} loss", loss.item(), float(loss_ref), **TOL)
    g_ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray, g_ref))
    for key, p in mod.named_parameters():
        assert_close(f"remat {policy} grad {key}", p.grad, g_ref[key], **TOL)


class _CountMM(TorchDispatchMode):
    """Counts aten.mm calls that reach the kernels: an op the checkpoint
    policy returns from its cache does not get here."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _backward_counts(policy, monkeypatch, remat=True):
    """(attention forwards, those again in the backward, aten.mm calls in
    the backward)."""
    _, tcfg = _configs(policy)
    mod = tllama.Llama(dataclasses.replace(tcfg, remat_layers=remat))
    mod.attn_fn = functools.partial(fa.flash_attention, causal=True)
    calls = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    tokens, targets = _batch()
    loss = mod(torch.tensor(tokens).long(),
               targets=torch.tensor(targets).long())
    forwards = len(calls)
    with _CountMM() as counter:
        loss.backward()
    return forwards, len(calls) - forwards, counter.mm


def test_policies_keep_what_they_name(monkeypatch):
    L = tllama.LLAMA_TINY_SCAN.num_layers
    counts = {p: _backward_counts(p, monkeypatch) for p in POLICIES}
    assert {p: c[0] for p, c in counts.items()} == dict.fromkeys(POLICIES, L)
    # the recompute runs the attention forward again unless it is saved
    assert {p: c[1] for p, c in counts.items()} == {
        None: L, "dots": L, "attn_out": 0, "dots_attn": 0}
    # under dots the backward runs the products a backward without remat
    # runs: none of the forward's again
    no_remat = _backward_counts(None, monkeypatch, remat=False)
    assert no_remat[1] == 0
    assert counts["dots"][2] == counts["dots_attn"][2] == no_remat[2]
    # full remat runs the layer's projections again (the recompute stops
    # before down_proj, whose output the backward does not read)
    assert counts[None][2] == counts["attn_out"][2] == no_remat[2] + 6 * L


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl.remat_context("everything")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.Llama(dataclasses.replace(tllama.LLAMA_TINY,
                                         remat_policy="nothing"))
