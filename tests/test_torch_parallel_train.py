"""Training steps of the port on gloo ranks against the JAX package and
against one device, on the CPU, in fp32 (tests/torch_dist_workers.py runs
the ranks; each joins a process group of the test's size).

- 4 ranks of llama_tiny at MeshPlan(fsdp=2, tp=2), 3 AdamW steps, against
  the JAX package's train step at the same plan on 4 of its CPU devices,
  from the same weights on the same numpy batches: losses at rtol 1e-4,
  parameters at atol 1e-4 (the whole-slice AdamW bars of
  test_torch_train.py). The ranks' DTensor placements split over tp the
  torch dimensions `param_placements` names.
- 8 ranks at dp=2 × fsdp=2 × tp=2 take the step one device takes (the
  counterpart of `__graft_entry__.dryrun_multichip(8)`): loss and
  parameters within 1e-5.
- 4 ranks at tp=4, which splits llama_tiny's 4 heads and not its 2 kv
  heads (each rank takes its heads of the expanded k/v), within 1e-5 of one
  device.
- Adafactor at fsdp=2 on a scanned Llama whose leaves factor (dim 128,
  hidden 256) against one device, within 1e-6: the row, column and leaf
  means are the whole leaf's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as workers
from tests.torch_parity import assert_close
from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.models.registry import ModelBundle as JaxBundle
from vodascheduler_tpu.models.registry import _lm_batch, _lm_fused_loss
from vodascheduler_tpu.parallel.mesh import MeshPlan as JaxPlan
from vodascheduler_tpu.parallel.sharding import TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import make_optimizer, make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.parallel import sharding

BATCH = 8


def _one_device(steps, **kwargs):
    """The session on one device (no process group) in this process."""
    return workers.train(0, 1, steps=steps, batch=BATCH, **kwargs)


def _save(tmp_path, state_dict, name="params.pt"):
    path = str(tmp_path / name)
    torch.save(state_dict, path)
    return path


def test_four_ranks_fsdp2_tp2_match_the_jax_package(tmp_path):
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype="float32")
    jbundle = JaxBundle(name="llama_tiny", module=jllama.Llama(jcfg),
                        make_batch=_lm_batch(jcfg.vocab_size, workers.SEQ),
                        loss_fn=_lm_fused_loss, rules=TRANSFORMER_RULES,
                        seq_len=workers.SEQ)
    setup = make_train_setup(jbundle, 4, devices=jax.devices()[:4],
                             plan=JaxPlan(fsdp=2, tp=2),
                             global_batch_size=BATCH)
    params = jbundle.module.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, workers.SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    # before the steps: the donated state may share the arrays' memory
    path = _save(tmp_path, bridge.flax_to_state_dict(params))
    state = {"params": jax.tree.map(np.copy, params), "extra": {},
             "opt_state": make_optimizer("adamw", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, setup.state_shardings)
    batches = workers.lm_batches(jcfg.vocab_size, 3, BATCH)
    jlosses = []
    for b in batches:
        jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                             for k, v in b.items()}, setup.batch_shardings)
        state, loss = setup.train_step(state, jb)
        jlosses.append(float(loss))

    rank0 = workers.run_ranks("train", 4, tmp_path,
                              plan={"fsdp": 2, "tp": 2}, steps=3,
                              batch=BATCH, params=path)[0]
    assert rank0["plan"] == {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1, "ep": 1,
                             "pp": 1}
    for i, (got, want) in enumerate(zip(rank0["losses"], jlosses)):
        assert_close(f"4 ranks fsdp2 tp2 loss step {i}", got, want, atol=0,
                     rtol=1e-4)
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 state["params"]))
    for key, p in rank0["after"].items():
        assert_close(f"4 ranks fsdp2 tp2 params after 3 steps {key}", p,
                     ref[key], atol=1e-4, rtol=0)
    # tp splits what the rules say, on torch's dimension; fsdp splits
    # every parameter (FSDP2, dimension 0 or the one after tp's)
    from vodascheduler_tpu_torch.models import llama as tllama
    want = sharding.param_placements(
        tllama.Llama(dataclasses.replace(tllama.LLAMA_TINY, dtype="float32"),
                     device="meta"),
        sharding.TRANSFORMER_RULES, {"dp": 1, "fsdp": 2, "tp": 2})
    for name, split in rank0["placements"].items():
        assert split.get("tp") == want[name]["split"].get("tp"), name
        assert "fsdp" in split, name
    assert any("tp" in s for s in rank0["placements"].values())


@pytest.mark.parametrize("world, plan", [
    (8, {"dp": 2, "fsdp": 2, "tp": 2}),
    (4, {"tp": 4}),
])
def test_a_sharded_step_equals_one_devices(tmp_path, world, plan):
    one = _one_device(1)
    path = _save(tmp_path, one["before"])
    rank0 = workers.run_ranks("train", world, tmp_path, plan=plan, steps=1,
                              batch=BATCH, params=path)[0]
    tag = "x".join(f"{k}{v}" for k, v in plan.items())
    assert_close(f"{tag} one step loss", rank0["losses"][0],
                 one["losses"][0], atol=0, rtol=1e-5)
    for key, p in rank0["after"].items():
        assert_close(f"{tag} one step params {key}", p, one["after"][key],
                     atol=1e-5, rtol=0)


def test_adafactor_at_fsdp2_equals_one_devices(tmp_path):
    kwargs = {"optimizer": "adafactor",
              "cfg": {"dim": 128, "mlp_hidden": 256, "scan_layers": True}}
    one = _one_device(3, **kwargs)
    path = _save(tmp_path, one["before"])
    rank0 = workers.run_ranks("train", 2, tmp_path, plan={"fsdp": 2},
                              steps=3, batch=BATCH, params=path,
                              **kwargs)[0]
    for i, (got, want) in enumerate(zip(rank0["losses"], one["losses"])):
        assert_close(f"adafactor fsdp2 loss step {i}", got, want, atol=0,
                     rtol=1e-6)
    for key, p in rank0["after"].items():
        assert_close(f"adafactor fsdp2 params after 3 steps {key}", p,
                     one["after"][key], atol=1e-6, rtol=0)
