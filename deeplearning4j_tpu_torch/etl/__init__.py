"""ETL of the port: the streaming normalizers and their lowering to torch
ops on a device."""
from .normalizer import (DataNormalizer, NormalizerMinMaxScaler,
                         NormalizerStandardize)

__all__ = ["DataNormalizer", "NormalizerMinMaxScaler",
           "NormalizerStandardize"]
