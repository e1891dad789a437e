"""`python -m vodascheduler_tpu_torch.service` — run the full control plane."""

import sys

from vodascheduler_tpu_torch.service.app import main

sys.exit(main())
