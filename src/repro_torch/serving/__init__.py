"""Serving layer of the port: LM continuous batching.  (Graph-query
serving comes with its own slice.)"""
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
