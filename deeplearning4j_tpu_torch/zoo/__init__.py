"""Model zoo of the port: `transformer_lm` and `resnet50`."""
from .models import resnet50, transformer_lm

__all__ = ["resnet50", "transformer_lm"]
