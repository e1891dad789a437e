"""Cluster backends: how the scheduler actually runs jobs.

The reference delegates execution to Kubernetes + the Kubeflow MPI-Operator
(create/scale/delete MPIJob CRDs and let the controller manage pods). This
framework owns its execution substrate behind the `ClusterBackend`
interface:

- `fake.FakeClusterBackend`: hermetic simulated cluster driven by a
  VirtualClock — the testing substrate the reference never finished
  (SURVEY.md §4: fake clientsets in an empty test stub), and the engine of
  trace replay.
- `local.LocalBackend`: real PyTorch trainer processes
  (runtime/supervisor.py) on the local machine's GPUs, one card index
  list per grant.
- `multihost.MultiHostBackend`: one supervisor process per host with a
  backend-issued coordinator address, where the hosts' supervisors meet
  and number their ranks (runtime/supervisor.py).

The port has no `gke` backend yet (ROADMAP A21).
"""

from vodascheduler_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterEvent,
    JobHandle,
    ResizePath,
)
from vodascheduler_tpu_torch.cluster.local import LocalBackend
from vodascheduler_tpu_torch.cluster.multihost import MultiHostBackend
