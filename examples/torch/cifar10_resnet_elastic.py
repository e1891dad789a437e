#!/usr/bin/env python
"""Elastic CIFAR-10-shaped ResNet with linear learning-rate scaling, on
the port.

Counterpart of examples/jax/cifar10_resnet_elastic.py: resnet_tiny
(32x32x3 images, 10 classes, BatchNorm on its running statistics) through
the elastic loop (elastic_loop.py), at learning rate BASE_LR · chips, the
rule the reference applies at every resize. A job holds one card until
multi-GPU training (ROADMAP A10), so the scale is 1 for now.

Run on the card:   python examples/torch/cifar10_resnet_elastic.py
On the CPU:        VODA_FORCE_CPU_DEVICES=1 python ... --workdir W
"""

from __future__ import annotations

import argparse
import sys

import elastic_loop

BASE_LR = 1e-3  # per-card learning rate; scaled linearly with cards


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-chips", type=int, default=1)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps-per-epoch", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--workdir",
                   default=elastic_loop.default_workdir("voda-cifar-elastic"))
    p.add_argument("--job-name", default="cifar10-resnet-elastic")
    args = p.parse_args(argv)

    from vodascheduler_tpu_torch.models import get_model
    return elastic_loop.run(get_model("resnet_tiny"), args.workdir,
                            args.job_name, args.epochs, args.steps_per_epoch,
                            args.batch_size, BASE_LR * args.num_chips,
                            num_chips=args.num_chips)


if __name__ == "__main__":
    sys.exit(main())
