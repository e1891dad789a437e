"""Trace replay: Philly-style workloads replayed against the simulated
cluster under any scheduling algorithm.

This is the evaluation harness the reference never shipped (its quantitative
evaluation lives only in the external IC2E'23 paper; SURVEY.md §6) and the
source of the framework's headline benchmark: chip utilization and JCT on a
64-job trace (BASELINE.md north star).
"""

from vodascheduler_tpu_torch.replay.trace import TraceJob, philly_like_trace, load_trace, save_trace
from vodascheduler_tpu_torch.replay.simulator import ReplayHarness, ReplayReport
