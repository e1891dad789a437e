"""The port's Llama modules against their flax counterparts in the JAX
package, in fp32 on the CPU, on the same weights (through the bridge) and
the same numpy inputs.

Tolerance: atol 1e-5 and rtol 1e-5 for outputs and losses (fp32 sums in a
different order); gradients through a whole model at atol 1e-5, rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.models import layers as jl
from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.ops.chunked_ce import chunked_softmax_ce as jax_ce
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import layers as tl
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.ops.chunked_ce import chunked_softmax_ce

from tests.torch_parity import assert_close

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
D, H, KV, HD, F = 32, 4, 2, 8, 64


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _block_params(seed):
    """flax DecoderBlock params, norm scales drawn away from ones."""
    cfg = jl.AttnConfig(num_heads=H, num_kv_heads=KV, head_dim=HD)
    block = jl.DecoderBlock(cfg, F)
    params = block.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, D)))["params"]
    params = jax.tree.map(np.asarray, params)
    params["attn_norm"]["scale"] = 1 + 0.1 * _x(seed + 1, (D,))
    params["mlp_norm"]["scale"] = 1 + 0.1 * _x(seed + 2, (D,))
    return block, params


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_rmsnorm():
    _, params = _block_params(0)
    x = _x(1, (2, 8, D))
    ref = jl.RMSNorm().apply({"params": params["attn_norm"]}, x)
    norm = tl.RMSNorm(D)
    norm.load_state_dict({"scale": torch.tensor(params["attn_norm"]["scale"])})
    assert_close("RMSNorm", norm(torch.tensor(x)), ref, **TOL)


def test_rope_rotates_split_halves():
    x = _x(2, (2, 8, 3, 16))
    pos = np.random.default_rng(3).integers(0, 100, (2, 8)).astype(np.int32)
    ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    assert_close("rope", got, ref, **TOL)


@pytest.mark.parametrize("part", ["attn", "mlp", "block"])
def test_block_parts_match_flax(part):
    block, params = _block_params(4)
    sd = bridge._layer_to_torch(params, "")
    sd = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
    x = _x(5, (2, 8, D))
    cfg = tl.AttnConfig(num_heads=H, num_kv_heads=KV, head_dim=HD)
    if part == "attn":
        jcfg = jl.AttnConfig(num_heads=H, num_kv_heads=KV, head_dim=HD)
        ref = jl.Attention(jcfg).apply({"params": params["attn"]}, x)
        mod = tl.Attention(cfg, D)
        mod.load_state_dict(_sub(sd, "attn."))
    elif part == "mlp":
        ref = jl.SwiGLU(F).apply({"params": params["mlp"]}, x)
        mod = tl.SwiGLU(D, F)
        mod.load_state_dict(_sub(sd, "mlp."))
    else:
        ref = block.apply({"params": params}, x)
        mod = tl.DecoderBlock(cfg, D, F)
        mod.load_state_dict(sd)
    assert_close(f"{part} (GQA {H}/{KV})", mod(torch.tensor(x)), ref, **TOL)


def test_gqa_expands_heads_interleaved():
    """jnp.repeat(k, 2, axis=2) is h0,h0,h1,h1 — not Tensor.repeat's
    h0,h1,h0,h1; an attention whose two kv heads differ tells them apart."""
    _, params = _block_params(6)
    x = _x(7, (1, 6, D))
    jcfg = jl.AttnConfig(num_heads=H, num_kv_heads=KV, head_dim=HD)
    seen = []
    jl.Attention(jcfg, attn_fn=lambda q, k, v: seen.append(np.asarray(k)) or
                 jl.reference_attention(q, k, v)).apply(
        {"params": params["attn"]}, x)
    mod = tl.Attention(tl.AttnConfig(num_heads=H, num_kv_heads=KV,
                                     head_dim=HD), D)
    sd = bridge._layer_to_torch(params, "")
    mod.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                         for k, v in _sub(sd, "attn.").items()})
    mod.attn_fn = lambda q, k, v: seen.append(k.detach().numpy()) or \
        tl.reference_attention(q, k, v)
    mod(torch.tensor(x))
    assert_close("GQA expanded k", seen[1], seen[0], **TOL)


@pytest.mark.parametrize("S,chunks", [(16, 8), (12, 5), (12, 1)])
def test_chunked_ce_loss_and_grads(S, chunks):
    B, V = 2, 40
    h = _x(8, (B, S, D))
    w = _x(9, (D, V)) * 0.2
    t = np.random.default_rng(10).integers(0, V, (B, S)).astype(np.int32)
    ref, (gh_ref, gw_ref) = jax.value_and_grad(
        lambda h, w: jax_ce(h, w, jnp.asarray(t), num_chunks=chunks),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = chunked_softmax_ce(ht, wt, torch.tensor(t).long(),
                              num_chunks=chunks)
    loss.backward()
    tag = f"chunked_ce S={S} chunks={chunks}"
    assert_close(f"{tag} loss", loss.item(), float(ref), **TOL)
    assert_close(f"{tag} d_hidden", ht.grad, gh_ref, **TOL)
    assert_close(f"{tag} d_head", wt.grad, gw_ref, **TOL)


def _configs(name):
    jcfg = dataclasses.replace(getattr(jllama, name), dtype="float32",
                               remat_layers=True)
    tcfg = dataclasses.replace(getattr(tllama, name), dtype="float32",
                               remat_layers=True)
    return jcfg, tcfg


def _flax_llama(jcfg, seed=0):
    model = jllama.Llama(jcfg)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["LLAMA_TINY", "LLAMA_TINY_SCAN"])
def test_llama_logits_loss_and_grads(name):
    jcfg, tcfg = _configs(name)
    model, params = _flax_llama(jcfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    logits_ref = model.apply({"params": params}, tokens)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: model.apply({"params": p}, tokens, targets=targets))(params)

    mod = tllama.Llama(tcfg)
    mod.load_state_dict(bridge.flax_to_state_dict(params))
    tt, tg = torch.tensor(tokens).long(), torch.tensor(targets).long()
    with torch.no_grad():
        assert_close(f"{name} logits", mod(tt), logits_ref, **TOL)
    loss = mod(tt, targets=tg)
    loss.backward()
    assert_close(f"{name} loss", loss.item(), float(loss_ref), **TOL)
    g_ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray, g_ref))
    for key, p in mod.named_parameters():
        assert_close(f"{name} grad {key}", p.grad, g_ref[key], **GRAD_TOL)


@pytest.mark.parametrize("name", ["LLAMA_TINY", "LLAMA_TINY_SCAN"])
def test_bridge_round_trip_is_exact(name):
    jcfg, tcfg = _configs(name)
    _, params = _flax_llama(jcfg, seed=3)
    mod = tllama.Llama(tcfg)
    mod.load_state_dict(bridge.flax_to_state_dict(params))
    back = bridge.state_dict_to_flax(mod.state_dict(), tcfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))


def test_init_std_matches_flax():
    """flax's initializers by distribution: each parameter's std within
    10% of the flax init's (norms are ones in both)."""
    jcfg, tcfg = _configs("LLAMA_TINY_SCAN")
    _, params = _flax_llama(jcfg, seed=5)
    ref = bridge.flax_to_state_dict(params)
    mod = tllama.Llama(tcfg)
    mod.reset_parameters(torch.Generator().manual_seed(5))
    for key, p in mod.state_dict().items():
        want = ref[key]
        if key.endswith(".scale"):
            torch.testing.assert_close(p, want)
            continue
        ratio = (p.std() / want.std()).item()
        assert abs(ratio - 1) < 0.1, (key, ratio)


def test_llama_presets_match_reference():
    for name in ("LLAMA3_8B", "LLAMA_350M", "LLAMA_350M_BYTES",
                 "LLAMA_350M_8K", "LLAMA_350M_AF", "LLAMA_350M_8K_AF",
                 "LLAMA_1B", "LLAMA_TINY", "LLAMA_TINY_SCAN"):
        j, t = getattr(jllama, name), getattr(tllama, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert (j.head_dim, j.param_count) == (t.head_dim, t.param_count)
