"""Serving layer of the port: graph-query continuous batching over payload
lanes (`graph_scheduler`) and LM continuous batching (`scheduler`)."""
from repro_torch.serving.graph_scheduler import (GraphQueryBatcher, Query,
                                                 ServingFrontend,
                                                 poisson_ticks)
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = ["GraphQueryBatcher", "Query", "ServingFrontend", "poisson_ticks",
           "ContinuousBatcher", "Request"]
