"""Communicators of the distributed engine (`repro_torch.core.dist_engine`)
and the worlds of processes that run it (`repro_torch.dist.world`)."""
from repro_torch.dist.comm import ProcessGroupComm, StackedComm

__all__ = ["ProcessGroupComm", "StackedComm"]
