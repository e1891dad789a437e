"""How far the JAX package's own bf16 step is from an fp32 twin of the
same weights, per model family, on the CPU.

chip_smoke.py's families phase holds each of the port's families, in
bf16 on the card, against an fp32 twin: the step-0 loss and every
parameter's gradient (largest difference over the gradient's largest
value). This script measures the same two gaps for the reference's
modules (each bundle's own batch at B=8, weights from PRNGKey(0), the
fp32 twin by `dtype="float32"`), so that a bar can be read against what
the reference itself shows:

    JAX_PLATFORMS=cpu python scripts/reference_twin_gap.py --models resnet50

One JSON line per model: the loss gap, and the three worst parameters by
the gradient gap, with the seconds the CPU took.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gaps(name: str, batch_size: int) -> dict:
    import jax
    import jax.numpy as jnp

    from vodascheduler_tpu.models import get_model

    t0 = time.time()
    bundle = get_model(name)
    batch = bundle.make_batch(batch_size, jax.random.PRNGKey(1))
    key = "images" if "images" in batch else "inputs"
    kw = {"train": False} if bundle.has_batch_stats else {}
    variables = jax.jit(lambda r, x: bundle.module.init(r, x, **kw))(
        jax.random.PRNGKey(0), batch[key])
    extra = {k: v for k, v in variables.items() if k != "params"}
    out = {}
    for dtype in ("bfloat16", "float32"):
        module = type(bundle.module)(dataclasses.replace(
            bundle.module.cfg, dtype=dtype))

        def apply(p, x, module=module, **k):
            return module.apply({"params": p, **extra}, x, **kw, **k)
        out[dtype] = jax.jit(jax.value_and_grad(
            lambda p: bundle.loss_fn(apply, p, batch)))(variables["params"])
    (loss, g), (loss_t, g_t) = out["bfloat16"], out["float32"]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(g_t)[0])
    grad = sorted(
        (float(jnp.abs(a.astype(jnp.float32) - flat_t[p]).max()
               / jnp.abs(flat_t[p]).max()), jax.tree_util.keystr(p))
        for p, a in jax.tree_util.tree_flatten_with_path(g)[0])
    return {"model": name, "batch": batch_size,
            "loss_gap": abs(float(loss) - float(loss_t)) / abs(float(loss_t)),
            "grad_gap_worst": grad[-3:], "cpu_s": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", default="resnet50,bert_base,vit_l16,nmt_base")
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    for name in args.models.split(","):
        print(json.dumps(gaps(name, args.batch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
