"""The port's Adafactor against optax.adafactor, in fp32 on the CPU.

- One update rule: `optax.adafactor(1e-3)` and the port's `Adafactor` over
  five updates of the same random gradients, on leaves shaped like the
  reference's at a small width: factored over (1, 2) and over (2, 1), and
  unfactored ones (a q/k/v kernel whose second largest axis is under 128,
  a stacked norm scale); then the same leaves gathered from one parameter
  per layer in the port's layouts ([out, in] weights, q/k/v heads). Parameters at 1e-6 of the leaf's largest value
  (an update is ~1e-3 of its parameter, so fp32 rounding of the
  parameter, not of the update, sets this floor); the second-moment
  statistics at 1e-6 relative.
- Five training steps: the port's TrainSession against the JAX package's
  train step from one bridged init of a scanned Llama wide enough that
  o_proj, the MLP, the embedding and the head factor and q/k/v do not
  (dim 160, 4 heads of 40). Losses at 1e-4 relative, parameters at 1e-4
  absolute, as the AdamW test holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.models.registry import ModelBundle as JaxBundle
from vodascheduler_tpu.models.registry import _lm_batch as jax_lm_batch
from vodascheduler_tpu.models.registry import _lm_fused_loss
from vodascheduler_tpu.parallel.sharding import TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import make_optimizer as jax_optimizer
from vodascheduler_tpu.runtime.train import make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.models.registry import llama_bundle
from vodascheduler_tpu_torch.runtime import TrainSession, make_optimizer
from vodascheduler_tpu_torch.runtime.optim import Adafactor, factored_dims

from tests.torch_parity import assert_close

LEAVES = {
    "gate_proj-like [2,160,256]": ((2, 160, 256), (1, 2)),
    "down_proj-like [2,256,160]": ((2, 256, 160), (2, 1)),
    "qkv-like [2,160,4,16]": ((2, 160, 4, 16), None),
    "norm-like [2,160]": ((2, 160), None),
    "embed-like [300,160]": ((300, 160), (1, 0)),
    "head-like [160,300]": ((160, 300), (0, 1)),
}


@pytest.mark.parametrize("name", list(LEAVES))
def test_update_matches_optax(name):
    shape, dims = LEAVES[name]
    assert factored_dims(shape) == dims
    rng = np.random.default_rng(0)
    p0 = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    tx = optax.adafactor(1e-3)
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = make_optimizer("adafactor", 1e-3)([tp])
    assert isinstance(opt, Adafactor)
    for _ in range(5):
        g = rng.standard_normal(shape).astype(np.float32)
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.tensor(g)
        opt.step()
    scale = float(np.max(np.abs(np.asarray(jp))))
    assert_close(f"adafactor {name} params", tp, jp, atol=1e-6 * scale,
                 rtol=0)
    factored = jstate[0]
    state = opt.state[tp]
    assert state["step"] == int(factored.count) == 5
    if dims is None:
        assert_close(f"adafactor {name} v", state["v"], factored.v,
                     atol=0, rtol=1e-6)
        assert "v_row" not in state
    else:
        assert_close(f"adafactor {name} v_row", state["v_row"],
                     factored.v_row, atol=0, rtol=1e-6)
        assert_close(f"adafactor {name} v_col", state["v_col"],
                     factored.v_col, atol=0, rtol=1e-6)


# Leaves gathered from one parameter per layer, in the port's layouts:
# (leaf shape, parameter shape, transposed).
GROUPED = {
    "dense [2,160,256] from [256,160] weights": ((2, 160, 256), (256, 160),
                                                 True),
    "heads [2,160,4,16] from [64,160] weights": ((2, 160, 4, 16), (64, 160),
                                                 True),
    "norm [2,160] from [160] scales": ((2, 160), (160,), False),
    # Mixtral's experts: 4-D leaves, factored over their last two axes
    "experts [2,4,128,256] from [4,128,256] kernels": ((2, 4, 128, 256),
                                                      (4, 128, 256), False),
    "experts [2,4,256,128] from [4,256,128] kernels": ((2, 4, 256, 128),
                                                      (4, 256, 128), False),
}


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_leaf_matches_optax(name):
    """A leaf stacked from per-layer parameters is updated as optax updates
    the stacked leaf: its factoring and both block RMS span the layers. The
    layers' scales differ (×1, ×3), so an RMS taken per layer would not
    pass."""
    shape, pshape, transposed = GROUPED[name]
    rng = np.random.default_rng(2)
    leaf0 = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    leaf0[1] *= 3
    tx = optax.adafactor(1e-3)
    jp, jstate = jnp.asarray(leaf0), tx.init(jnp.asarray(leaf0))

    def to_param(a):  # a slice of the leaf in the port's layout
        return a.reshape(pshape[::-1]).T if transposed else a.reshape(pshape)

    params = [torch.nn.Parameter(torch.tensor(np.ascontiguousarray(
        to_param(leaf0[i])))) for i in range(2)]
    opt = Adafactor([{"params": params, "leaf": name, "shape": shape,
                      "stacked": True, "transposed": transposed}], lr=1e-3)
    for _ in range(5):
        g = rng.standard_normal(shape).astype(np.float32)
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        for i, p in enumerate(params):
            p.grad = torch.tensor(np.ascontiguousarray(to_param(g[i])))
        opt.step()
    ref = np.asarray(jp)
    scale = float(np.max(np.abs(ref)))
    for i, p in enumerate(params):
        assert_close(f"adafactor grouped {name} layer {i}", p,
                     to_param(ref[i]), atol=1e-6 * scale, rtol=0)


def test_state_dict_round_trip():
    shape = (2, 256, 160)
    rng = np.random.default_rng(1)
    p = torch.nn.Parameter(torch.tensor(rng.standard_normal(shape),
                                        dtype=torch.float32))
    opt = Adafactor([p], lr=1e-3)
    p.grad = torch.ones(shape)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    other = Adafactor([q], lr=5e-3)
    other.load_state_dict(opt.state_dict())
    assert other.state[q]["step"] == 1
    assert other.param_groups[0]["lr"] == 1e-3
    for key in ("v_row", "v_col"):
        assert torch.equal(other.state[q][key], opt.state[p][key])


SEQ, BATCH, STEPS = 16, 2, 5
WIDE = dict(vocab_size=300, dim=160, num_layers=2, num_heads=4,
            num_kv_heads=2, mlp_hidden=320, max_seq_len=64,
            rope_base=10000.0, dtype="float32", scan_layers=True,
            remat_layers=True)


def test_param_groups_are_the_reference_leaves():
    tcfg = tllama.LlamaConfig(**WIDE)
    groups = bridge.reference_param_groups(
        tllama.Llama(tcfg).named_parameters(), tcfg)
    jcfg = jllama.LlamaConfig(**WIDE)
    params = jax.eval_shape(
        lambda: jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               params["params"])[0]}
    assert {g["leaf"]: tuple(g["shape"]) for g in groups} == ref
    q = next(g for g in groups if g["leaf"].endswith("q_proj/kernel"))
    assert q["shape"] == (2, 160, 4, 40) and factored_dims(q["shape"]) is None
    assert all(factored_dims(g["shape"]) is not None for g in groups
               if g["leaf"].endswith(("o_proj/kernel", "mlp/gate_proj/kernel",
                                      "embed/embedding", "lm_head_kernel")))


def test_five_adafactor_steps_match_jax():
    jcfg = jllama.LlamaConfig(**WIDE)
    tcfg = tllama.LlamaConfig(**WIDE)
    jbundle = JaxBundle(name="llama_wide", module=jllama.Llama(jcfg),
                        make_batch=jax_lm_batch(jcfg.vocab_size, SEQ),
                        loss_fn=_lm_fused_loss, rules=TRANSFORMER_RULES,
                        seq_len=SEQ, optimizer="adafactor")
    setup = make_train_setup(jbundle, num_chips=1,
                             devices=jax.devices()[:1],
                             global_batch_size=BATCH)
    params = jbundle.module.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    state = {"params": params, "extra": {},
             "opt_state": jax_optimizer("adafactor", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(setup.train_step_raw)

    session = TrainSession(llama_bundle("llama_wide", tcfg, SEQ, "adafactor"),
                           global_batch_size=BATCH, device="cpu")
    assert isinstance(session.optimizer, Adafactor)
    session.module.load_state_dict(bridge.flax_to_state_dict(params))

    rng = np.random.default_rng(0)
    for i in range(STEPS):
        tokens = rng.integers(0, tcfg.vocab_size, (BATCH, SEQ + 1))
        jbatch = {"inputs": jnp.asarray(tokens[:, :-1], jnp.int32),
                  "targets": jnp.asarray(tokens[:, 1:], jnp.int32)}
        tbatch = {"inputs": torch.tensor(tokens[:, :-1]),
                  "targets": torch.tensor(tokens[:, 1:])}
        state, jloss = step(state, jbatch)
        tloss = session.train_step(tbatch)
        assert_close(f"adafactor train loss step {i}", tloss.item(),
                     float(jloss), atol=0, rtol=1e-4)
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 state["params"]))
    for key, p in session.module.state_dict().items():
        assert_close(f"adafactor train params after {STEPS} steps {key}", p,
                     ref[key], atol=1e-4, rtol=0)
    # the parameters moved by more than the tolerance
    init = bridge.flax_to_state_dict(params)
    assert max((p - init[k]).abs().max().item()
               for k, p in session.module.state_dict().items()) > 1e-3
