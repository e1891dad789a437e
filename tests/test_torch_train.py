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
from vodascheduler_tpu.models.registry import get_model as jax_get_model
from vodascheduler_tpu.parallel.sharding import TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import make_optimizer as jax_optimizer
from vodascheduler_tpu.runtime.train import make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.models.registry import get_model, llama_bundle
from vodascheduler_tpu_torch.runtime import TrainSession, make_optimizer
from vodascheduler_tpu_torch.runtime import optim
from vodascheduler_tpu_torch.runtime.optim import Adafactor

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


@pytest.mark.parametrize("name", ["llama_1b", "llama_350m_af",
                                  "llama_350m_8k_af"])
def test_adafactor_presets_match_the_reference(name):
    """The bundle's config, sequence length and optimizer are the JAX
    package's, field by field."""
    ref = jax_get_model(name)
    bundle = get_model(name)
    assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(
        ref.module.cfg)
    assert (bundle.seq_len, bundle.optimizer) == (ref.seq_len, ref.optimizer)


def test_adamw_matches_optax_hyperparameters():
    opt = make_optimizer("adamw", 1e-3)([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    # optax's adamw default decay, which torch's default (1e-2) is not
    assert inspect.signature(optax.adamw).parameters[
        "weight_decay"].default == group["weight_decay"]
    # adafactor is optax.adafactor's rule with its defaults
    # (tests/test_torch_adafactor.py holds it to optax)
    adafactor = make_optimizer("adafactor", 1e-3)(
        [torch.nn.Parameter(torch.zeros(1))])
    assert isinstance(adafactor, Adafactor)
    assert adafactor.param_groups[0]["lr"] == 1e-3
    defaults = inspect.signature(optax.adafactor).parameters
    assert (defaults["decay_rate"].default, defaults["decay_offset"].default,
            defaults["min_dim_size_to_factor"].default,
            defaults["eps"].default, defaults["clipping_threshold"].default,
            defaults["multiply_by_parameter_scale"].default,
            defaults["momentum"].default,
            defaults["weight_decay_rate"].default) == (
        optim.DECAY_RATE, optim.DECAY_OFFSET, optim.MIN_DIM_SIZE_TO_FACTOR,
        optim.EPS, optim.CLIPPING_THRESHOLD, True, None, None)
    with pytest.raises(ValueError):
        make_optimizer("sgd", 1e-3)


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
    # several chips are ranks of a process group (test_torch_parallel*.py)
    with pytest.raises(ValueError, match="process group"):
        TrainSession(get_model("llama_tiny"), num_chips=2, device="cpu")


def test_registry_ports_the_single_card_adamw_llamas():
    for name in ("llama_tiny", "llama_350m", "llama_350m_8k"):
        bundle = get_model(name)
        assert bundle.name == name and bundle.optimizer == "adamw"
    for name in ("llama_1b", "llama_350m_af", "llama_350m_8k_af"):
        bundle = get_model(name)
        assert bundle.name == name and bundle.optimizer == "adafactor"
    for name in ("llama_tiny_text", "llama_350m_text"):
        bundle = get_model(name)  # the real corpus: ported with the data
        assert bundle.name == name and bundle.optimizer == "adamw"
    for name in ("llama3_8b", "llama8b"):  # ported with the mesh
        bundle = get_model(name)
        assert bundle.name == "llama3_8b" and bundle.params_b == 8.0
    for name in ("mixtral_8x7b", "mixtral"):  # ported with the ep axis
        bundle = get_model(name)
        assert bundle.name == "mixtral_8x7b" and bundle.params_b == 47.0
    with pytest.raises(ValueError):
        get_model("no_such_model")
