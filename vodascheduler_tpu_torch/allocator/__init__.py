"""Resource allocator: runs a scheduling algorithm over ready jobs.

Reference counterpart: pkg/allocator — a stateless HTTP microservice
(POST /allocation) that loads speedup curves from Mongo when the algorithm
needs them, then calls the algorithm library. Here the allocator is an
in-process component (service/rest.py exposes the same HTTP surface for
API parity).
"""

from vodascheduler_tpu_torch.allocator.allocator import AllocationRequest, ResourceAllocator
