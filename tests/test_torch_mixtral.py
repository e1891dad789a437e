"""The port's Mixtral against the JAX package's, on the CPU.

- MIXTRAL_TINY at dtype float32, scanned with remat, under each dispatch
  (routed, gather, dense) and each remat policy (None, dots, attn_out,
  dots_attn): logits, loss and every gradient, on weights drawn with numpy
  and passed through the bridge, and one numpy batch. A policy changes no
  number, so the JAX model of each dispatch is the reference of all four.
  The experts compute in bf16 in both packages, which round their products
  and SwiGLU's elementwise steps differently: logits and each gradient are
  held to 2e-2 of their largest magnitude (the bf16 bar), the loss to 2e-4
  relative. Every token's k-th and (k+1)-th router probability differ by
  more than 1e-4 in the port's pass, so both packages route every token
  alike and a pass is not luck. (The unscanned layout:
  `test_torch_mixtral_layout.py`.)
- `reference_param_groups` names the leaves of the reference's scanned
  Mixtral tree with their shapes, at MIXTRAL_TINY and, on the meta device,
  MIXTRAL_SMALL, and Adafactor factors them as optax does.
- The presets and the registry: the four Mixtral bundles, mixtral_8x7b
  among them since the ep axis.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.models import mixtral as jmixtral
from vodascheduler_tpu.models import registry as jregistry
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import get_model
from vodascheduler_tpu_torch.models import mixtral as tmixtral
from vodascheduler_tpu_torch.ops import moe_dispatch
from vodascheduler_tpu_torch.ops import flash_attention as fa
from vodascheduler_tpu_torch.runtime.optim import factored_dims

from tests.torch_parity import assert_close

BF16_SHARE = 2e-2
LOSS_RTOL = 2e-4
POLICIES = [None, "dots", "attn_out", "dots_attn"]
DISPATCHES = ["routed", "gather", "dense"]


def _configs(scan, dispatch, policy=None):
    kw = dict(dtype="float32", dispatch=dispatch, scan_layers=scan,
              remat_layers=scan, remat_policy=policy)
    return (dataclasses.replace(jmixtral.MIXTRAL_TINY, **kw),
            dataclasses.replace(tmixtral.MIXTRAL_TINY, **kw))


@functools.cache
def _weights(scan):
    """A state_dict of MIXTRAL_TINY drawn with numpy: each matrix at its
    init std (read from a module initialised from its own seeded
    generator, so that no test's draws from torch's global generator move
    it), norm scales around 1."""
    return _draw_weights(scan)


def _draw_weights(scan):
    _, tcfg = _configs(scan, "routed")
    rng = np.random.default_rng(7)
    module = tmixtral.Mixtral(tcfg)
    module.reset_parameters(torch.Generator().manual_seed(7))
    out = {}
    for name, p in module.state_dict().items():
        std = 0.1 if name.endswith("scale") else p.std().item()
        base = 1.0 if name.endswith("scale") else 0.0
        out[name] = torch.tensor(
            base + std * rng.standard_normal(tuple(p.shape)),
            dtype=torch.float32)
    return out


def _batch():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 256, (2, 16)).astype(np.int32)
    return tokens, targets


@functools.cache
def _reference(scan, dispatch):
    """(logits, loss, grads as a port state_dict) of the JAX model."""
    jcfg, tcfg = _configs(scan, dispatch)
    params = bridge.state_dict_to_flax(_weights(scan), tcfg)
    model = jmixtral.Mixtral(jcfg)
    tokens, targets = _batch()
    logits = model.apply({"params": params}, tokens)
    loss, grads = jax.value_and_grad(
        lambda p: model.apply({"params": p}, tokens, targets=targets))(params)
    grads = bridge.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    return np.asarray(logits), float(loss), grads


def _check(tag, got, ref):
    scale = float(np.abs(np.asarray(ref)).max())
    assert scale > 0, tag
    assert_close(tag, got, ref, atol=BF16_SHARE * scale, rtol=0)


def _routing_gaps(monkeypatch):
    """Records, for every call of top_k_gating, the smallest gap between a
    token's k-th and (k+1)-th probability."""
    gaps = []
    gating = moe_dispatch.top_k_gating

    def recording(probs, top_k, eps=1e-9):
        p = torch.sort(probs.detach(), dim=-1, descending=True)[0]
        gaps.append((p[..., top_k - 1] - p[..., top_k]).min().item())
        return gating(probs, top_k, eps)
    monkeypatch.setattr(moe_dispatch, "top_k_gating", recording)
    return gaps


def _run_parity(scan, dispatch, policy, monkeypatch):
    _, tcfg = _configs(scan, dispatch, policy)
    logits_ref, loss_ref, g_ref = _reference(scan, dispatch)
    mod = tmixtral.Mixtral(tcfg)
    mod.load_state_dict(_weights(scan))
    # the attention operator, as on the card (its plain version here)
    mod.attn_fn = functools.partial(fa.flash_attention, causal=True)
    gaps = _routing_gaps(monkeypatch)
    tokens, targets = _batch()
    tt, tg = torch.tensor(tokens).long(), torch.tensor(targets).long()
    tag = f"mixtral {'scan' if scan else 'unscanned'} {dispatch} {policy}"
    with torch.no_grad():
        _check(f"{tag} logits", mod(tt), logits_ref)
    loss = mod(tt, targets=tg)
    loss.backward()
    assert min(gaps) > 1e-4, gaps
    assert len(gaps) >= 2 * tcfg.num_layers
    assert_close(f"{tag} loss", loss.item(), loss_ref, atol=0,
                 rtol=LOSS_RTOL)
    assert set(g_ref) == {n for n, _ in mod.named_parameters()}
    for key, p in mod.named_parameters():
        _check(f"{tag} grad {key}", p.grad, g_ref[key])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_scanned_mixtral_matches_jax(dispatch, policy, monkeypatch):
    _run_parity(True, dispatch, policy, monkeypatch)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("scan", [True, False])
def test_weights_do_not_depend_on_torch_global_generator(scan):
    """The parity weights are drawn from numpy at scales read from a module
    initialised from its own seeded generator: whatever an earlier test in
    the same process drew from torch's global generator, they are the same
    tensors."""
    runs = []
    for seed in (0, 1, 12345):
        torch.manual_seed(seed)
        torch.rand(seed % 7 + 1)  # an earlier test's draws
        runs.append(_draw_weights(scan))
    for other in runs[1:]:
        assert other.keys() == runs[0].keys()
        for name in runs[0]:
            assert torch.equal(other[name], runs[0][name]), name


@pytest.mark.parametrize("name", ["MIXTRAL_TINY", "MIXTRAL_SMALL"])
def test_param_groups_are_the_reference_leaves(name):
    tcfg = getattr(tmixtral, name)
    tcfg = dataclasses.replace(tcfg, scan_layers=True)
    jcfg = dataclasses.replace(getattr(jmixtral, name), scan_layers=True)
    groups = bridge.reference_param_groups(
        tmixtral.Mixtral(tcfg, device="meta").named_parameters(), tcfg)
    ref = jax.eval_shape(lambda: jmixtral.Mixtral(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = {k: tuple(v.shape) for k, v in _flat(ref).items()}
    got = {g["leaf"]: tuple(g["shape"]) for g in groups}
    assert got == want
    block = "layers_scan/block/moe/"
    router = next(g for g in groups if g["leaf"] == block + "router/kernel")
    assert router["transposed"] and factored_dims(router["shape"]) is None
    # optax factors an expert leaf over its [in, out] axes where both
    # reach 128 (MIXTRAL_SMALL), not at all at MIXTRAL_TINY's widths
    small = name == "MIXTRAL_SMALL"
    for leaf, dims in (("experts_gate_kernel", (2, 3)),
                       ("experts_up_kernel", (2, 3)),
                       ("experts_down_kernel", (3, 2))):
        g = next(g for g in groups if g["leaf"] == block + leaf)
        assert not g["transposed"] and len(g["shape"]) == 4
        assert factored_dims(g["shape"]) == (dims if small else None)
    if name == "MIXTRAL_SMALL":
        assert got[block + "experts_gate_kernel"] == (12, 8, 640, 1792)
        assert got[block + "router/kernel"] == (12, 640, 8)
        assert got["layers_scan/block/attn/q_proj/kernel"] == (12, 640, 10,
                                                               64)


def test_presets_match_the_reference():
    for name in ("MIXTRAL_8X7B_LIKE", "MIXTRAL_SMALL", "MIXTRAL_SMALL_AF",
                 "MIXTRAL_TINY"):
        j, t = getattr(jmixtral, name), getattr(tmixtral, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert j.head_dim == t.head_dim


def test_registry_builds_the_mixtral_bundles():
    for name in ("mixtral_tiny", "mixtral_small", "mixtral_small_af"):
        bundle, ref = get_model(name), jregistry.get_model(name)
        assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(
            ref.module.cfg), name
        assert (bundle.seq_len, bundle.optimizer, bundle.num_experts) == (
            ref.seq_len, ref.optimizer, ref.num_experts), name
    for name in ("mixtral_8x7b", "mixtral"):  # ported with the ep axis
        bundle, ref = get_model(name), jregistry.get_model(name)
        assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(
            ref.module.cfg) == dataclasses.asdict(tmixtral.MIXTRAL_8X7B_LIKE)
        assert (bundle.name, bundle.params_b, bundle.seq_len,
                bundle.num_experts) == ("mixtral_8x7b", 47.0, 4096, 8)
