"""ICI-topology-aware placement: worker→host binding with migration
minimization.

Reference counterpart: pkg/placement — best-fit node consolidation plus
Hungarian (munkres) relabeling to maximize workers that stay put, with
migration done by deleting pods (placement_manager.go). Here the same
consolidation core packs TPU hosts, contiguity is scored against the ICI
torus (topology.py), and "delete the pod" becomes "restart the worker
process elsewhere" — which on TPU is the same checkpoint-restart mechanism
as an elastic resize.
"""

from vodascheduler_tpu_torch.placement.manager import PlacementManager, PlacementDecision
from vodascheduler_tpu_torch.placement.state import HostState, JobPlacement
from vodascheduler_tpu_torch.placement.topology import PoolTopology, SliceShape
