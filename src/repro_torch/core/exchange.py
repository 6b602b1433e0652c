"""ExchangeBackend: the communication seam of the superstep.

This package has the single-shard backend only: `NullExchange`, where every
destination is local and nothing moves.  It speaks the phase protocol that
`repro_torch.core.plan.execute_plan` drives: `local_phase` produces the
superstep's carry (for the sync shape, the fully ⊕-reduced combine array),
`merge` folds it into what apply consumes (the identity here),
`carry_init` builds an identity-valued placeholder, and `carry_pending`
says whether the carry holds contributions the halt test must wait for.
"""
from __future__ import annotations

import torch


class _SyncPhase:
    """Sync phase shape: the whole ⊕-reduce is the local phase and the merge
    is the identity, so the BSP loop is refresh → reduce → apply."""

    phases = "sync"

    def local_phase(self, engine, part, state, carry=None):
        return self.reduce(engine, part, state)

    def merge(self, carry):
        return carry

    def carry_init(self, engine, part):
        p = engine.program
        return torch.full((part.num_slots,) + tuple(p.payload_shape),
                          p.monoid.identity, dtype=p.msg_dtype,
                          device=part.device)

    def carry_pending(self, carry):
        return False  # a sync carry is consumed by the very next merge


class NullExchange(_SyncPhase):
    """Single shard: all destinations are local; refresh is the identity."""

    def refresh(self, state):
        return state

    def reduce(self, engine, part, state):
        return engine.scatter_combine(part, state)


NULL_EXCHANGE = NullExchange()
