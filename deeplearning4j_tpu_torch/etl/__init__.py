"""ETL of the port (counterpart of deeplearning4j_tpu/etl), one import
surface:

- `schema` / `transform` — the column `Schema` and the chainable,
  JSON-serializable `TransformProcess`, executed vectorized on NumPy column
  batches (the JAX package's JSON, byte for byte);
- `normalizer` — `NormalizerStandardize` / `NormalizerMinMaxScaler`;
- `pipeline` — `ParallelPipelineExecutor`: N-worker read -> transform ->
  batch over MagicQueue, ordered or unordered, with backpressure,
  deterministic close() and exactly-once errors (numpy threads only);
- `prefetch` — `DevicePrefetcher`: batches staged on the card from pinned
  memory on side streams while the step computes, with the narrow-wire
  ingest mode;
- `device_transform` — `DeviceIngest` / `lower_normalizer`: a fitted
  TransformProcess + DataNormalizer as torch ops on the device, fused into
  the training step by `network.set_ingest`.
"""
from .device_transform import DeviceIngest, lower_normalizer
from .normalizer import (DataNormalizer, NormalizerMinMaxScaler,
                         NormalizerStandardize)
from .pipeline import ParallelPipelineExecutor
from .prefetch import DevicePrefetcher
from .schema import Column, ColumnType, Schema
from .transform import TransformProcess

__all__ = ["Schema", "Column", "ColumnType", "TransformProcess",
           "DataNormalizer", "NormalizerStandardize",
           "NormalizerMinMaxScaler", "ParallelPipelineExecutor",
           "DevicePrefetcher", "DeviceIngest", "lower_normalizer"]
