#!/usr/bin/env python
"""Synthetic throughput benchmark — examples/sec for any model of the
port's registry.

Counterpart of examples/jax/synthetic_benchmark.py: random data, warmup
batches, then timed iterations of batches, each ended by a
synchronisation of the device (a step returns before the card finishes).
It prints examples/sec on the device it ran on; a CPU run's rate is the
CPU's, not the card's.

Run on the card:   python examples/torch/synthetic_benchmark.py --model resnet50
On the CPU:        VODA_FORCE_CPU_DEVICES=1 python ... --model resnet_tiny
"""

from __future__ import annotations

import argparse
import sys
import time

import elastic_loop


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet_tiny")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-warmup-batches", type=int, default=5)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    dev = elastic_loop.device()
    session = TrainSession(get_model(args.model), 1,
                           global_batch_size=args.batch_size, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"model: {args.model}, device: {name}, batch: {args.batch_size}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    session.run_steps(args.num_warmup_batches)
    sync()
    rates = []
    for i in range(args.num_iters):
        t0 = time.monotonic()
        session.run_steps(args.num_batches_per_iter)
        sync()
        rate = args.num_batches_per_iter * args.batch_size / (
            time.monotonic() - t0)
        rates.append(rate)
        print(f"iter {i}: {rate:.1f} examples/sec")
    print(f"total examples/sec on {name}: {float(np.mean(rates)):.1f} "
          f"(+/- {float(np.std(rates)):.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
