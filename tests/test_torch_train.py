"""Whole-slice parity: three AdamW steps of the port's TrainSession against
the JAX package's train step, from the same bridged init of
LLAMA_TINY_SCAN with remat, in fp32 on the CPU, on the same numpy batches.

Tolerance: losses at rtol 1e-4, parameters after three steps at atol 1e-4
(fp32 sums in a different order, amplified by Adam's normalisation of
small gradients).
"""

import dataclasses
import inspect

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
from vodascheduler_tpu_torch.models.registry import get_model, llama_bundle
from vodascheduler_tpu_torch.runtime import TrainSession, make_optimizer

from tests.torch_parity import assert_close

SEQ, BATCH, STEPS = 16, 2, 3


def test_three_adamw_steps_match_jax():
    jcfg = dataclasses.replace(jllama.LLAMA_TINY_SCAN, dtype="float32",
                               remat_layers=True)
    tcfg = dataclasses.replace(tllama.LLAMA_TINY_SCAN, dtype="float32",
                               remat_layers=True)
    jbundle = JaxBundle(name="llama_tiny_scan", module=jllama.Llama(jcfg),
                        make_batch=jax_lm_batch(jcfg.vocab_size, SEQ),
                        loss_fn=_lm_fused_loss, rules=TRANSFORMER_RULES,
                        seq_len=SEQ)
    setup = make_train_setup(jbundle, num_chips=1,
                             devices=jax.devices()[:1],
                             global_batch_size=BATCH)
    params = jbundle.module.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    state = {"params": params, "extra": {},
             "opt_state": jax_optimizer("adamw", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(setup.train_step_raw)

    session = TrainSession(llama_bundle("llama_tiny_scan", tcfg, SEQ),
                           global_batch_size=BATCH, device="cpu")
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
        assert_close(f"train loss step {i}", tloss.item(), float(jloss),
                     atol=0, rtol=1e-4)
    assert session.step == STEPS == int(state["step"])
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 state["params"]))
    for key, p in session.module.state_dict().items():
        assert_close(f"train params after {STEPS} steps {key}", p, ref[key],
                     atol=1e-4, rtol=0)


def test_adamw_matches_optax_hyperparameters():
    opt = make_optimizer("adamw", 1e-3)([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    # optax's adamw default decay, which torch's default (1e-2) is not
    assert inspect.signature(optax.adamw).parameters[
        "weight_decay"].default == group["weight_decay"]
    with pytest.raises(NotImplementedError):
        make_optimizer("adafactor", 1e-3)


def test_session_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainSession(get_model("llama_tiny"))


def test_session_runs_and_counts_steps_on_cpu():
    session = TrainSession(get_model("llama_tiny"), global_batch_size=2,
                           device="cpu")
    assert session.module.attn_fn is None  # the plain path on the CPU
    loss = session.run_steps(2)
    assert np.isfinite(loss) and session.step == 2
    with pytest.raises(NotImplementedError):
        TrainSession(get_model("llama_tiny"), num_chips=2, device="cpu")


def test_registry_ports_the_single_card_adamw_llamas():
    for name in ("llama_tiny", "llama_350m", "llama_350m_8k"):
        bundle = get_model(name)
        assert bundle.name == name and bundle.optimizer == "adamw"
    for name in ("llama3_8b", "llama8b", "llama_1b", "mixtral_tiny"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(name)
    with pytest.raises(ValueError):
        get_model("no_such_model")
