"""The elastic pattern every example here runs, in one place.

    resume from checkpoint | train | checkpoint each epoch | CSV row each
    epoch | SIGTERM => checkpoint + preempted exit (3)

The port's counterpart of the loop each script of examples/jax/ writes
out. A resize is a restart: the scheduler stops the job (SIGTERM), the job
checkpoints and exits 3, and the next incarnation resumes from the
checkpoint at the step it reached, on the batches it would have seen.
Jobs run on one card until multi-GPU training comes (ROADMAP A10).
"""

from __future__ import annotations

import os
import signal
import sys
import tempfile
import time
from typing import Callable, Optional

# Runnable from a bare checkout: put the repo root on sys.path when the
# package isn't installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def default_workdir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def device():
    """The card, or the CPU under VODA_FORCE_CPU_DEVICES=1, as the
    supervisor chooses; without either it raises."""
    from vodascheduler_tpu_torch.runtime.supervisor import _devices
    return _devices()[0]


def run(bundle, workdir: str, job_name: str, epochs: int,
        steps_per_epoch: int, batch_size: int, learning_rate: float = 1e-3,
        num_chips: int = 1,
        on_epoch: Optional[Callable[[object], str]] = None) -> int:
    """Trains `bundle` elastically under `workdir`; returns the exit code
    (0 done, 3 preempted). `on_epoch(session)` adds text to each epoch's
    line (a held-out evaluation, say)."""
    from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        EpochCsvLogger,
    )
    from vodascheduler_tpu_torch.runtime.checkpoint import latest_step
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    dev = device()
    ckpt_dir = os.path.join(workdir, "ckpt")
    # (1) Resume: a previous incarnation's checkpoint holds the weights,
    # the optimizer, the step and the seed, so the batch stream too.
    if latest_step(ckpt_dir) is not None:
        session = TrainSession.resume(bundle, num_chips, ckpt_dir,
                                      global_batch_size=batch_size,
                                      device=dev,
                                      learning_rate=learning_rate)
        print(f"resumed at step {session.step} on {num_chips} chips",
              flush=True)
    else:
        session = TrainSession(bundle, num_chips, global_batch_size=batch_size,
                               device=dev, learning_rate=learning_rate)

    # (2) Preemption: the scheduler's resize or halt arrives as SIGTERM.
    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(flag=True))
    signal.signal(signal.SIGINT, lambda *_: stop.update(flag=True))

    logger = EpochCsvLogger(os.path.join(workdir, "metrics"), job_name,
                            total_epochs=epochs, global_batch_size=batch_size)
    logger.next_epoch = session.step // steps_per_epoch
    total_steps = epochs * steps_per_epoch
    print(f"{bundle.name} on {dev}: {total_steps} steps", flush=True)
    while session.step < total_steps:
        t0 = time.monotonic()
        end = min(total_steps,
                  (session.step // steps_per_epoch + 1) * steps_per_epoch)
        n_steps = end - session.step
        while session.step < end:
            if stop["flag"]:
                session.save(ckpt_dir)
                session.finish_saves()
                print("preempted: checkpointed, exiting for resize/restart",
                      flush=True)
                return PREEMPTED_EXIT_CODE
            loss = session.run_steps(min(10, end - session.step))
        dt = time.monotonic() - t0
        # (3) One CSV row per epoch feeds the speedup-curve collector.
        logger.log_epoch(epoch_time_sec=dt, step_time_sec=dt / n_steps,
                         workers=num_chips, start_time=str(time.time()))
        # (4) A checkpoint every epoch.
        session.save(ckpt_dir)
        extra = f" {on_epoch(session)}" if on_epoch else ""
        print(f"epoch {session.step // steps_per_epoch}: loss={loss:.4f}"
              f"{extra} {dt:.1f}s", flush=True)
    session.finish_saves()
    print("training complete", flush=True)
    return 0
