#!/usr/bin/env python
"""Elastic MNIST MLP — the "hello world" of elastic training, on the port.

Counterpart of examples/jax/mnist_mlp_elastic.py: the mnist_mlp bundle
(synthetic 28x28 images) through the elastic loop (elastic_loop.py):
resume | train | checkpoint each epoch | CSV row | SIGTERM => exit 3.

Run on the card:   python examples/torch/mnist_mlp_elastic.py --workdir W
On the CPU:        VODA_FORCE_CPU_DEVICES=1 python ... --workdir W
"""

from __future__ import annotations

import argparse
import sys

import elastic_loop


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--workdir",
                   default=elastic_loop.default_workdir("voda-mnist-elastic"))
    p.add_argument("--job-name", default="mnist-mlp-elastic")
    args = p.parse_args(argv)

    from vodascheduler_tpu_torch.models import get_model
    return elastic_loop.run(get_model("mnist_mlp"), args.workdir,
                            args.job_name, args.epochs, args.steps_per_epoch,
                            args.batch_size)


if __name__ == "__main__":
    sys.exit(main())
