"""Training Mixtral in the port against the JAX package, on the CPU.

- Five Adafactor steps: the port's TrainSession against the JAX package's
  train step from one init (numpy weights through the bridge) of a scanned
  Mixtral wide enough that its expert leaves factor (dim 128, hidden 256,
  4 experts, 2 layers, gather dispatch), on the same numpy batches. The
  experts compute in bf16 in both packages and round differently, so the
  bars are wider than the Llama test's fp32 ones. Losses at 1e-3
  relative. A factored leaf's update (the experts, o_proj, the embedding
  and the head) within 1e-2 of the reference's, relative L2. An
  unfactored leaf's first update is sign(g) per element (optax's v is g²
  at step one), so an element whose gradient lies within bf16 noise of 0
  steps the other way: of every leaf at most 2% of the elements may be
  off by more than 2e-2 of its largest move (one element of a 128-long
  norm scale is 0.8%). Every step, the port's k-th and (k+1)-th router
  probabilities differ by more than 1e-4, so both packages route alike.
- A one-epoch mixtral_tiny job through the port's supervisor
  (VODA_FORCE_CPU_DEVICES=1) trains, checkpoints and writes its CSV row.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vodascheduler_tpu.metricscollector import csv_logger as jax_csv
from vodascheduler_tpu.models import mixtral as jmixtral
from vodascheduler_tpu.models.registry import ModelBundle as JaxBundle
from vodascheduler_tpu.models.registry import _lm_batch as jax_lm_batch
from vodascheduler_tpu.models.registry import _lm_fused_loss
from vodascheduler_tpu.parallel.sharding import TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import make_optimizer as jax_optimizer
from vodascheduler_tpu.runtime.train import make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.models import mixtral as tmixtral
from vodascheduler_tpu_torch.models.registry import mixtral_bundle
from vodascheduler_tpu_torch.runtime import TrainSession
from vodascheduler_tpu_torch.runtime.optim import Adafactor, factored_dims

from tests.test_torch_mixtral import _routing_gaps
from tests.torch_parity import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS = 16, 2, 5
WIDE = dict(vocab_size=300, dim=128, num_layers=2, num_heads=2,
            num_kv_heads=1, mlp_hidden=256, num_experts=4, top_k=2,
            rope_base=10000.0, dtype="float32", dispatch="gather",
            scan_layers=True, remat_layers=True)


def test_five_adafactor_steps_match_jax(monkeypatch):
    jcfg = jmixtral.MixtralConfig(**WIDE)
    tcfg = tmixtral.MixtralConfig(**WIDE)
    jbundle = JaxBundle(name="mixtral_wide", module=jmixtral.Mixtral(jcfg),
                        make_batch=jax_lm_batch(jcfg.vocab_size, SEQ),
                        loss_fn=_lm_fused_loss, rules=TRANSFORMER_RULES,
                        seq_len=SEQ, num_experts=4, optimizer="adafactor")
    setup = make_train_setup(jbundle, num_chips=1,
                             devices=jax.devices()[:1],
                             global_batch_size=BATCH)

    session = TrainSession(mixtral_bundle("mixtral_wide", tcfg, SEQ,
                                          "adafactor"),
                           global_batch_size=BATCH, device="cpu")
    assert isinstance(session.optimizer, Adafactor)
    rng = np.random.default_rng(5)
    # the scales read from a module initialised from its own seeded
    # generator, not from torch's global one
    session.module.reset_parameters(torch.Generator().manual_seed(5))
    init = {}
    for name, p in session.module.state_dict().items():
        std = 0.1 if name.endswith("scale") else p.std().item()
        init[name] = torch.tensor((1.0 if name.endswith("scale") else 0.0)
                                  + std * rng.standard_normal(p.shape),
                                  dtype=torch.float32)
    session.module.load_state_dict(init)
    experts = [g for g in session.optimizer.param_groups
               if "experts_" in g["leaf"]]
    assert len(experts) == 3 and all(
        len(g["shape"]) == 4 and factored_dims(g["shape"]) for g in experts)

    params = bridge.state_dict_to_flax(init, tcfg)
    state = {"params": params, "extra": {},
             "opt_state": jax_optimizer("adafactor", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(setup.train_step_raw)
    gaps = _routing_gaps(monkeypatch)
    for i in range(STEPS):
        tokens = rng.integers(0, tcfg.vocab_size, (BATCH, SEQ + 1))
        jbatch = {"inputs": jnp.asarray(tokens[:, :-1], jnp.int32),
                  "targets": jnp.asarray(tokens[:, 1:], jnp.int32)}
        tbatch = {"inputs": torch.tensor(tokens[:, :-1]),
                  "targets": torch.tensor(tokens[:, 1:])}
        state, jloss = step(state, jbatch)
        tloss = session.train_step(tbatch)
        assert_close(f"mixtral adafactor train loss step {i}", tloss.item(),
                     float(jloss), atol=0, rtol=1e-3)
    assert min(gaps) > 1e-4, min(gaps)
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 state["params"]))
    factored = {p for g in session.optimizer.param_groups
                if factored_dims(g["shape"]) for p in g["params"]}
    for (key, p), param in zip(session.module.state_dict().items(),
                               session.module.parameters()):
        moved = (ref[key] - init[key]).abs().max().item()
        assert moved > 0, key
        err = (p - ref[key]).abs()
        rel = (err.norm() / (ref[key] - init[key]).norm()).item()
        share = (err > 2e-2 * moved).float().mean().item()
        print(f"parity mixtral adafactor update {key}: rel_l2={rel:.3g} "
              f"share_off={share:.3g} max_abs_err={err.max().item():.3g}")
        assert share <= 2e-2, key
        if param in factored:
            assert rel <= 1e-2, key


def test_mixtral_tiny_job_through_the_supervisor(tmp_path):
    workdir = tmp_path / "moe"
    workdir.mkdir()
    spec = JobSpec(name="moe_job", model="mixtral_tiny", global_batch_size=2,
                   steps_per_epoch=2, config=JobConfig(epochs=1))
    (workdir / "spec.json").write_text(json.dumps(spec.to_dict()))
    env = {k: v for k, v in os.environ.items() if k != "VODA_TRACE_DIR"}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               VODA_FORCE_CPU_DEVICES="1", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.supervisor",
         "--workdir", str(workdir), "--num-chips", "1"],
        capture_output=True, text=True, env=env, cwd=str(workdir),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "epoch 0 loss " in proc.stdout
    assert os.listdir(workdir / "ckpt") == ["step_0000000002"]
    rows = jax_csv.read_epoch_csv(str(workdir / "metrics" / "moe_job.csv"))
    assert [(r["epoch"], r["workers"], r["global_batch_size"])
            for r in rows] == [("0", "1", "2")]
    assert float(rows[0]["step_time_sec"]) > 0
