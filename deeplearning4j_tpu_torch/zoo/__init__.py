"""Model zoo of the port (this slice: `transformer_lm`)."""
from .models import transformer_lm

__all__ = ["transformer_lm"]
