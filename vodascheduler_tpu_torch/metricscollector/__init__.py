"""The metrics feedback loop: per-epoch telemetry -> learned speedup curves.

Reference counterpart: python/metrics_collector (a k8s CronJob reading
training-side CSVs and updating Mongo job_info) + the training-side Keras
CSV logger (examples/py/tensorflow2/callbacks.py). This loop is what makes
the info-driven algorithms (SRJF, ElasticSRJF, ElasticTiresias,
FfDLOptimizer, AFS-L) meaningful.
"""

from vodascheduler_tpu_torch.metricscollector.collector import (
    MetricsCollector,
    BackendRowSource,
    CsvDirRowSource,
)
from vodascheduler_tpu_torch.metricscollector.csv_logger import EpochCsvLogger, read_epoch_csv
