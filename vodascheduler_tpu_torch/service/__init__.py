"""Job admission service: the framework's front door.

Reference counterpart: pkg/service — REST API that validates job specs,
timestamps names, seeds job info, persists, and announces jobs to the
pool's scheduler.

The port holds the admission service; the REST layer, the daemon and
the app around it are not ported yet.
"""

from vodascheduler_tpu_torch.service.admission import AdmissionService
