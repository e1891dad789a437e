"""Job admission service: the framework's front door.

Reference counterpart: pkg/service — REST API that validates job specs,
timestamps names, seeds job info, persists, and announces jobs to the
pool's scheduler.
"""

from vodascheduler_tpu_torch.service.admission import AdmissionService
from vodascheduler_tpu_torch.service.daemon import SchedulerDaemon
