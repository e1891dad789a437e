"""The port's Mixtral in the reference's unscanned layout, its bridge and
its init, on the CPU.

- MIXTRAL_TINY at dtype float32, unscanned (the reference's `layer_{i}`
  tree, no remat), under each dispatch: logits, loss and every gradient
  against the JAX model, at the bars and with the routing check of
  `test_torch_mixtral.py`.
- The bridge's round trip is exact, scanned and unscanned: a reference
  tree drawn with numpy in the shapes of the reference's own
  `jax.eval_shape`, through the port's state_dict and back.
- Init: flax's lecun_normal takes E·D as the fan-in of a [E, D, H] expert
  kernel (E·H for [E, H, D]); the port's experts have that std, within 5%,
  at MIXTRAL_SMALL's widths.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.models import mixtral as jmixtral
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import mixtral as tmixtral

from tests.test_torch_mixtral import DISPATCHES, _configs, _flat, _run_parity


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_unscanned_mixtral_matches_jax(dispatch, monkeypatch):
    _run_parity(False, dispatch, None, monkeypatch)


@pytest.mark.parametrize("scan", [True, False])
def test_bridge_round_trip_is_exact(scan):
    jcfg, tcfg = _configs(scan, "gather")
    shapes = _flat(jax.eval_shape(lambda: jmixtral.Mixtral(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    rng = np.random.default_rng(4)
    tree = {}
    for path, leaf in shapes.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = rng.standard_normal(leaf.shape).astype(np.float32)
    mod = tmixtral.Mixtral(tcfg)
    mod.load_state_dict(bridge.flax_to_state_dict(tree))
    back = _flat(bridge.state_dict_to_flax(mod.state_dict(), tcfg))
    flat = _flat(tree)
    assert back.keys() == flat.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(back[path]), leaf,
                                      err_msg=path)
    assert any(p.endswith("moe/experts_down_kernel") for p in flat)


def test_expert_init_takes_flax_fan_in():
    """At MIXTRAL_SMALL's widths: std 1/√(E·D) for gate and up, 1/√(E·H)
    for down, as flax's lecun_normal draws them; the router 1/√D."""
    cfg = tmixtral.MIXTRAL_SMALL
    E, D, H = cfg.num_experts, cfg.dim, cfg.mlp_hidden
    block = tmixtral.MoEBlock(cfg)
    block.reset_experts(torch.Generator().manual_seed(0))
    for name, fan_in in (("experts_gate_kernel", E * D),
                         ("experts_up_kernel", E * D),
                         ("experts_down_kernel", E * H)):
        want = 1 / math.sqrt(fan_in)
        got = getattr(block, name).std().item()
        assert abs(got / want - 1) < 0.05, (name, got, want)
    flax_std = float(jnp.std(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (E, D, H))))
    assert abs(flax_std * math.sqrt(E * D) - 1) < 0.05, flax_std
    assert abs(block.router.weight.std().item() * math.sqrt(D) - 1) < 0.05
