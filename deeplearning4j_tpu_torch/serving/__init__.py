"""Serving plane of the port: /predict through the admission queue, the
dynamic batcher and the versioned registry, and /generate over the decode
scheduler."""
from .admission import (AdmissionQueue, DeadlineExceeded, RejectedError,
                        Request)
from .batcher import DynamicBatcher, bucket_for
from .metrics import ServingMetrics
from .registry import ModelRegistry, ModelVersion, NoModelDeployed
from .server import ServingServer

__all__ = ["AdmissionQueue", "DeadlineExceeded", "DynamicBatcher",
           "ModelRegistry", "ModelVersion", "NoModelDeployed",
           "RejectedError", "Request", "ServingMetrics", "ServingServer",
           "bucket_for"]
