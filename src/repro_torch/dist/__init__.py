"""Communicators of the distributed engine (`repro_torch.core.dist_engine`)."""
from repro_torch.dist.comm import StackedComm

__all__ = ["StackedComm"]
