#!/usr/bin/env python
"""Elastic training on REAL data — UCI handwritten digits, on the port.

Counterpart of examples/jax/digits_real_data_elastic.py: the digits_mlp
bundle through the elastic loop (elastic_loop.py), every batch real data
(no download: scikit-learn's copy, or the port's own), and each epoch's
line with the held-out loss and accuracy, so a resize shows that it
preserves training and not only the step count.

Run on the card:   python examples/torch/digits_real_data_elastic.py
On the CPU:        VODA_FORCE_CPU_DEVICES=1 python ... --workdir W
"""

from __future__ import annotations

import argparse
import sys

import elastic_loop


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--workdir",
                   default=elastic_loop.default_workdir("voda-digits-elastic"))
    p.add_argument("--job-name", default="digits-real-data")
    args = p.parse_args(argv)

    from vodascheduler_tpu_torch.data import (
        eval_classifier,
        load_digits_dataset,
    )
    from vodascheduler_tpu_torch.models import get_model

    dataset = load_digits_dataset()

    def held_out(session) -> str:
        ev = eval_classifier(session.module, dataset, device=session.device)
        return (f"held-out loss={ev['loss']:.4f} "
                f"accuracy={ev['accuracy']:.3f}")

    return elastic_loop.run(get_model("digits_mlp"), args.workdir,
                            args.job_name, args.epochs, args.steps_per_epoch,
                            args.batch_size, args.learning_rate,
                            on_epoch=held_out)


if __name__ == "__main__":
    sys.exit(main())
