"""The first AdamW steps of llama_350m_text on one batch of the real
corpus, in the JAX package and in the port, from the same weights, in fp32
on the CPU.

At the bundles' learning rate (1e-3, no warmup) the byte-level model's
loss does not fall step by step on one batch: the frequent bytes' rows of
the embedding and the head all move by lr at the first step. This script
shows that the reference does the same, so that a falling-loss check is
not held to what the reference itself does not do:

    JAX_PLATFORMS=cpu python scripts/text_lm_first_steps.py [--seq 256]

Full depth and width (24 layers, dim 1024, vocab 256); the sequence is cut
to --seq for the CPU. Each package runs in a process of its own, which
imports only it: the JAX side writes the initial weights and the batch to
a file under the system's temporary directory, the port's side reads them
through the bridge. Prints one JSON line: both packages' losses.

    python scripts/text_lm_first_steps.py --side port --seq 2048

runs the port alone on the card, at the job's sequence length, where the
reference cannot run: its own weights (TrainSession, seed 0) and windows drawn as
the JAX side draws them, in fp32 with the plain attention (`--dtype
bfloat16`: the bundle as a job runs it, through the kernels on a card).
Prints one JSON line: the port's losses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def jax_side(path: str, seq: int, batch: int, steps: int) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vodascheduler_tpu.data import load_text_corpus
    from vodascheduler_tpu.models import llama, registry
    from vodascheduler_tpu.runtime.train import make_optimizer
    from vodascheduler_tpu.runtime.train import make_train_setup

    cfg = dataclasses.replace(llama.LLAMA_350M_BYTES, dtype="float32")
    bundle = registry._text_lm_bundle("llama_350m_text", cfg, seq_len=seq)
    corpus = load_text_corpus()
    starts = np.random.default_rng(0).integers(
        0, corpus.train.size - seq - 1, batch)
    windows = np.stack([corpus.train[s:s + seq + 1] for s in starts]).astype(
        np.int64)
    setup = make_train_setup(bundle, num_chips=1, devices=jax.devices()[:1],
                             global_batch_size=batch)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: bundle.module.init(r, jnp.zeros((1, seq), jnp.int32)))(
            jax.random.PRNGKey(0))["params"])
    np.savez(path, windows=windows, **{f"p:{k}": v
                                       for k, v in _flatten(params).items()})
    state = {"params": params, "extra": {},
             "opt_state": make_optimizer("adamw", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(setup.train_step_raw)
    data = {"inputs": jnp.asarray(windows[:, :-1], jnp.int32),
            "targets": jnp.asarray(windows[:, 1:], jnp.int32)}
    losses = []
    for _ in range(steps):
        state, loss = step(state, data)
        losses.append(float(loss))
    return losses


def torch_side(path: str, seq: int, batch: int, steps: int) -> list:
    import numpy as np
    import torch

    from vodascheduler_tpu_torch import bridge
    from vodascheduler_tpu_torch.models import llama, registry
    from vodascheduler_tpu_torch.runtime import TrainSession

    saved = np.load(path)
    params = _unflatten({k[2:]: saved[k] for k in saved.files
                         if k.startswith("p:")})
    windows = saved["windows"]
    cfg = dataclasses.replace(llama.LLAMA_350M_BYTES, dtype="float32")
    session = TrainSession(registry._text_lm_bundle("llama_350m_text", cfg,
                                                    seq),
                           global_batch_size=batch, device="cpu")
    session.module.load_state_dict(bridge.flax_to_state_dict(params))
    data = {"inputs": torch.tensor(windows[:, :-1]),
            "targets": torch.tensor(windows[:, 1:])}
    return [session.train_step(data).item() for _ in range(steps)]


def port_side(seq: int, batch: int, steps: int, dtype: str) -> list:
    import numpy as np
    import torch

    from vodascheduler_tpu_torch.data import load_text_corpus
    from vodascheduler_tpu_torch.models import llama, registry
    from vodascheduler_tpu_torch.runtime import TrainSession

    if dtype == "float32":
        os.environ["VODA_FLASH_ATTENTION"] = "0"  # the kernels take bf16
    corpus = load_text_corpus()
    starts = np.random.default_rng(0).integers(
        0, corpus.train.size - seq - 1, batch)
    windows = torch.tensor(np.stack([corpus.train[s:s + seq + 1]
                                     for s in starts]).astype(np.int64),
                           device="cuda")
    cfg = dataclasses.replace(llama.LLAMA_350M_BYTES, dtype=dtype)
    session = TrainSession(registry._text_lm_bundle("llama_350m_text", cfg,
                                                    seq),
                           global_batch_size=batch, device="cuda")
    data = {"inputs": windows[:, :-1], "targets": windows[:, 1:]}
    return [session.train_step(data).item() for _ in range(steps)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--side", choices=("jax", "torch", "port"))
    p.add_argument("--state")
    p.add_argument("--dtype", default="float32")
    args = p.parse_args(argv)
    shape = (args.seq, args.batch, args.steps)
    if args.side == "port":
        print(json.dumps({"seq": args.seq, "batch": args.batch,
                          "dtype": args.dtype,
                          "port": port_side(*shape, args.dtype)}))
        return 0
    if args.side:
        side = jax_side if args.side == "jax" else torch_side
        print(json.dumps(side(args.state, *shape)))
        return 0
    out = {"seq": args.seq, "batch": args.batch}
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.npz")
        for name in ("jax", "torch"):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", name,
                 "--state", state, "--seq", str(args.seq), "--batch",
                 str(args.batch), "--steps", str(args.steps)],
                capture_output=True, text=True, check=True)
            out[name] = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
