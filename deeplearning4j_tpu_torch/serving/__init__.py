"""Serving plane of the port: /generate over the decode scheduler."""
from .admission import DeadlineExceeded, RejectedError
from .registry import ModelRegistry, NoModelDeployed
from .server import ServingServer

__all__ = ["DeadlineExceeded", "ModelRegistry", "NoModelDeployed",
           "RejectedError", "ServingServer"]
