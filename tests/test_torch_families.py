"""The port's model families (MLP, ResNet, BERT, ViT, NMT) against their
flax counterparts in the JAX package, in fp32 on the CPU, on the same
weights (through the bridge) and the same numpy inputs: logits, loss and
every gradient. The reference's configs compute in bf16; both packages'
configs are replaced by float32 here, as tests/test_torch_models.py does
for Llama.

Tolerance: 1e-5 abs+rel for logits, losses and gradients (fp32 sums in
another order). ResNet's gradients are held at atol 1e-5, rtol 1e-4: its
convolutions run in XLA's and oneDNN's own orders over fan-ins up to 576,
and each BatchNorm divides by the statistics' √var, which amplifies a
rounding difference in a few small gradient entries. LayerNorm and
BatchNorm scales, biases and statistics are drawn away from their init
values so that each enters the comparison.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.models import bert as jbert
from vodascheduler_tpu.models import layers as jl
from vodascheduler_tpu.models import mlp as jmlp
from vodascheduler_tpu.models import nmt as jnmt
from vodascheduler_tpu.models import registry as jreg
from vodascheduler_tpu.models import resnet as jresnet
from vodascheduler_tpu.models import vit as jvit
from vodascheduler_tpu.parallel.ring_attention import (
    reference_attention as jax_reference_attention,
)
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import bert as tbert
from vodascheduler_tpu_torch.models import layers as tl
from vodascheduler_tpu_torch.models import mlp as tmlp
from vodascheduler_tpu_torch.models import nmt as tnmt
from vodascheduler_tpu_torch.models import registry as treg
from vodascheduler_tpu_torch.models import resnet as tresnet
from vodascheduler_tpu_torch.models import vit as tvit
from vodascheduler_tpu_torch.parallel.ring_attention import reference_attention

from tests.torch_parity import assert_close

TOL = dict(atol=1e-5, rtol=1e-5)
RESNET_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B = 2


def _x(seed, shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _perturb(tree, seed):
    """Norm scales, biases and BatchNorm statistics away from init: each
    leaf named scale/bias/mean gets noise, var a positive draw."""
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k in ("scale", "bias", "mean") and v.ndim == 1:
                v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out
    return walk(tree)


def _f32(cfg):
    return (dataclasses.replace(cfg, dtype="float32")
            if hasattr(cfg, "dtype") else cfg)


def _images(seed, size, channels=3):
    return _x(seed, (B, size, size, channels))


def _labels(seed, classes):
    return np.random.default_rng(seed).integers(0, classes, (B,)).astype(
        np.int32)


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    t = torch.tensor(x)
    return t.long() if t.dtype == torch.int32 else t


def _case(name):
    """(jax module, torch module, jax loss, torch loss, numpy batch, has
    batch stats) of a family, fp32."""
    if name in ("MNIST_MLP", "DIGITS_MLP"):
        jcfg, tcfg = getattr(jmlp, name), getattr(tmlp, name)
        side = int(round(jcfg.input_dim ** 0.5))
        batch = {"images": _images(1, side, 1), "labels": _labels(2, 10)}
        return (jmlp.Mlp(jcfg), tmlp.Mlp(tcfg), jreg._cls_loss,
                treg._cls_loss, batch, False)
    if name.startswith("RESNET_TINY"):
        size = 33 if name.endswith("ODD") else 32
        jcfg = _f32(jresnet.RESNET_TINY)
        tcfg = _f32(tresnet.RESNET_TINY)
        batch = {"images": _images(3, size), "labels": _labels(4, 10)}
        return (jresnet.ResNet(jcfg), tresnet.ResNet(tcfg), jreg._cls_loss,
                treg._cls_loss, batch, True)
    if name == "BERT_TINY":
        jcfg, tcfg = _f32(jbert.BERT_TINY), _f32(tbert.BERT_TINY)
        batch = {"inputs": _tokens(5, jcfg.vocab_size, (B, 16)),
                 "targets": _tokens(6, jcfg.vocab_size, (B, 16))}
        return (jbert.Bert(jcfg), tbert.Bert(tcfg), jreg._mlm_loss,
                treg._mlm_loss, batch, False)
    if name == "VIT_TINY":
        jcfg, tcfg = _f32(jvit.VIT_TINY), _f32(tvit.VIT_TINY)
        batch = {"images": _images(7, jcfg.image_size),
                 "labels": _labels(8, jcfg.num_classes)}
        return (jvit.ViT(jcfg), tvit.ViT(tcfg), jreg._cls_loss,
                treg._cls_loss, batch, False)
    if name == "NMT_TINY":
        jcfg, tcfg = _f32(jnmt.NMT_TINY), _f32(tnmt.NMT_TINY)
        batch = {"inputs": {"src": _tokens(9, jcfg.vocab_size, (B, 12)),
                            "tgt": _tokens(10, jcfg.vocab_size, (B, 8))},
                 "targets": _tokens(11, jcfg.vocab_size, (B, 8))}
        return (jnmt.Seq2SeqTransformer(jcfg), tnmt.Seq2SeqTransformer(tcfg),
                jreg._lm_loss, treg._lm_loss, batch, False)
    raise KeyError(name)


def _init(jmod, batch, has_stats, seed=0):
    key = "images" if "images" in batch else "inputs"
    x = jax.tree.map(jnp.asarray, batch[key])
    kw = {"train": False} if has_stats else {}
    variables = jax.jit(lambda r, x: jmod.init(r, x, **kw))(
        jax.random.PRNGKey(seed), x)
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), seed + 1)
    stats = (_perturb(jax.tree.map(np.asarray, variables["batch_stats"]),
                      seed + 2) if has_stats else None)
    return params, stats


def _jax_apply(jmod, stats):
    if stats is None:
        return lambda p, x, **kw: jmod.apply({"params": p}, x, **kw)
    return lambda p, x, **kw: jmod.apply({"params": p, "batch_stats": stats},
                                         x, train=False, **kw)


FAMILIES = ["MNIST_MLP", "DIGITS_MLP", "RESNET_TINY", "RESNET_TINY_ODD",
            "BERT_TINY", "VIT_TINY", "NMT_TINY"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_loss_and_grads(name):
    jmod, tmod, jloss, tloss, batch, has_stats = _case(name)
    params, stats = _init(jmod, batch, has_stats)
    apply = _jax_apply(jmod, stats)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = "images" if "images" in batch else "inputs"
    logits_ref = jax.jit(apply)(params, jbatch[key])
    loss_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jloss(apply, p, jbatch)))(params)

    tmod.load_state_dict(bridge.tree_to_state_dict(params, stats))
    tbatch = _to_torch(batch)
    with torch.no_grad():
        assert_close(f"{name} logits", tmod(tbatch[key]),
                     np.asarray(logits_ref), **TOL)
    loss = tloss(tmod, tbatch)
    loss.backward()
    assert_close(f"{name} loss", loss.item(), float(loss_ref), **TOL)
    g_ref = bridge.tree_to_state_dict(jax.tree.map(np.asarray, g_ref))
    grad_tol = RESNET_GRAD_TOL if name.startswith("RESNET") else TOL
    names = [n for n, _ in tmod.named_parameters()]
    assert sorted(names) == sorted(g_ref)
    for n, p in tmod.named_parameters():
        assert_close(f"{name} grad {n}", p.grad, g_ref[n], **grad_tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_bridge_round_trip_is_exact(name):
    jmod, tmod, _, _, batch, has_stats = _case(name)
    params, stats = _init(jmod, batch, has_stats, seed=3)
    tmod.load_state_dict(bridge.tree_to_state_dict(params, stats))
    cfg = tmod.cfg
    if name.startswith("RESNET"):
        back, back_stats = bridge.resnet_to_flax(tmod.state_dict())
        pairs = [(params, back), (stats, back_stats)]
    elif name.endswith("MLP"):
        pairs = [(params, bridge.mlp_to_flax(tmod.state_dict()))]
    else:
        to_flax = {"BERT_TINY": bridge.bert_to_flax,
                   "VIT_TINY": bridge.vit_to_flax,
                   "NMT_TINY": bridge.nmt_to_flax}[name]
        pairs = [(params, to_flax(tmod.state_dict(), cfg))]
    for want, got in pairs:
        flat_a = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert flat_b[path].shape == leaf.shape, path
            np.testing.assert_array_equal(flat_b[path], leaf,
                                          err_msg=str(path))


def test_encoder_block_matches_flax():
    D, H, F = 32, 4, 64
    cfg = dict(num_heads=H, num_kv_heads=H, head_dim=D // H, causal=False,
               rope_base=0.0)
    x = _x(12, (B, 10, D))
    block = jl.EncoderBlock(jl.AttnConfig(**cfg), F)
    params = _perturb(jax.tree.map(np.asarray, block.init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"]), 2)
    ref = block.apply({"params": params}, jnp.asarray(x))
    mod = tl.EncoderBlock(tl.AttnConfig(**cfg), D, F)
    mod.load_state_dict(bridge.tree_to_state_dict(params))
    assert mod.ln1.eps == 1e-6
    assert_close("EncoderBlock", mod(torch.tensor(x)), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rope_base", [0.0, 10000.0])
def test_cross_attention_with_sk_unlike_sq(rope_base):
    """Keys and values from a context of another length; under RoPE the
    keys rotate by the context's positions."""
    D, H = 32, 4
    cfg = dict(num_heads=H, num_kv_heads=H, head_dim=D // H, causal=False,
               rope_base=rope_base)
    x, ctx = _x(13, (B, 6, D)), _x(14, (B, 11, D))
    attn = jl.Attention(jl.AttnConfig(**cfg))
    params = jax.tree.map(np.asarray, attn.init(
        jax.random.PRNGKey(3), jnp.asarray(x), context=jnp.asarray(ctx))[
            "params"])
    ref = attn.apply({"params": params}, jnp.asarray(x),
                     context=jnp.asarray(ctx))
    mod = tl.Attention(tl.AttnConfig(**cfg), D)
    mod.load_state_dict(bridge.tree_to_state_dict(params))
    got = mod(torch.tensor(x), context=torch.tensor(ctx))
    assert got.shape == (B, 6, D)
    assert_close(f"cross-attention rope_base={rope_base}", got,
                 np.asarray(ref), **TOL)


def test_reference_attention_takes_sk_unlike_sq():
    q, k, v = _x(15, (B, 5, 2, 8)), _x(16, (B, 9, 2, 8)), _x(17, (B, 9, 2, 8))
    ref = jax_reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=False)
    got = reference_attention(*(torch.tensor(a) for a in (q, k, v)),
                              causal=False)
    assert_close("reference_attention Sq=5 Sk=9", got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("size", [32, 33, 7, 8])
@pytest.mark.parametrize("kernel,stride", [((7, 7), (2, 2)), ((3, 3), (2, 2)),
                                           ((1, 1), (2, 2)), ((3, 3), (1, 1))])
def test_same_padding_matches_flax(size, kernel, stride):
    """flax pads SAME with the odd pixel after; a conv and a -inf max pool
    through `pad_same` agree with flax's at even and odd sizes."""
    x = _x(18, (B, size, size, 3))
    jconv = nn.Conv(4, kernel, stride, use_bias=False)
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(4),
                                                 jnp.asarray(x))["params"])
    ref = jconv.apply({"params": params}, jnp.asarray(x))
    mod = tl.Conv(3, 4, kernel, stride)
    mod.load_state_dict(bridge.tree_to_state_dict(params))
    got = mod(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    assert_close(f"SAME conv {kernel}/{stride} at {size}", got,
                 np.asarray(ref), **TOL)

    pool_ref = nn.max_pool(jnp.asarray(x), kernel, strides=stride,
                           padding="SAME")
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    pool = torch.nn.functional.max_pool2d(
        tl.pad_same(xt, kernel, stride, float("-inf")), kernel, stride)
    assert_close(f"SAME max_pool {kernel}/{stride} at {size}",
                 pool.permute(0, 2, 3, 1), np.asarray(pool_ref), atol=0,
                 rtol=0)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (33, 3, 2, (1, 1)), (32, 16, 16, (0, 0))])
def test_same_pads_put_the_odd_pixel_after(size, kernel, stride, want):
    assert tl.same_pads(size, kernel, stride) == want


def test_vit_patches_are_row_major_over_h_then_w():
    """A patch embedding that reads each patch's top-left pixel puts patch
    (i, j) at token 1 + i·w + j: the first layer sees them in that order,
    after the cls token."""
    cfg = dataclasses.replace(tvit.VIT_TINY, dtype="float32", num_layers=1)
    mod = tvit.ViT(cfg)
    with torch.no_grad():
        mod.patch_embed.weight.zero_()
        mod.patch_embed.weight[0, 0, 0, 0] = 1.0
        mod.pos_embed.zero_()
    seen = []
    mod.layer_0.register_forward_pre_hook(lambda _m, a: seen.append(a[0]))
    side, p = cfg.image_size // cfg.patch_size, cfg.patch_size
    img = torch.zeros(1, cfg.image_size, cfg.image_size, 3)
    for i in range(side):
        for j in range(side):
            img[0, i * p, j * p, 0] = i * side + j
    mod(img)
    tokens = seen[0][0, :, 0]
    assert torch.equal(tokens, torch.arange(side * side + 1,
                                            dtype=torch.float32) - 1
                       + (torch.arange(side * side + 1) == 0))


def test_batchnorm_uses_its_running_statistics():
    """The port's BatchNorm normalises by its buffers, in training mode
    too, as the reference's runtime applies the model (train=False)."""
    bn = tresnet.BatchNorm(3)
    with torch.no_grad():
        bn.mean.copy_(torch.tensor([1.0, 2.0, 3.0]))
        bn.var.copy_(torch.tensor([4.0, 1.0, 0.25]))
    x = torch.randn(2, 3, 5, 5)
    bn.train()
    y = bn(x)
    want = (x - bn.mean[:, None, None]) / torch.sqrt(
        bn.var[:, None, None] + 1e-5)
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)
    assert bn.mean.tolist() == [1.0, 2.0, 3.0]
    assert sorted(n for n, _ in bn.named_buffers()) == ["mean", "var"]


@pytest.mark.parametrize("name,port", [
    ("RESNET50", tresnet.RESNET50), ("BERT_BASE", tbert.BERT_BASE),
    ("VIT_L16", tvit.VIT_L16), ("NMT_BASE", tnmt.NMT_BASE),
    ("MNIST_MLP", tmlp.MNIST_MLP)])
def test_presets_match_the_reference(name, port):
    module = {"RESNET50": jresnet, "BERT_BASE": jbert, "VIT_L16": jvit,
              "NMT_BASE": jnmt, "MNIST_MLP": jmlp}[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(
        getattr(module, name))
