"""Continuous-batching serving scheduler (slot-based, vLLM-style at the
batch level); the counterpart of `repro/serving/scheduler.py`.

A fixed decode batch of B slots over a static KV cache: incoming requests
prefill, one at a time at their own length, into free slots while the other
slots keep decoding, so no decode step waits for a long prompt.  On a CUDA
cache every prefill runs the flash-attention kernel (K3) once per layer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [plen] int32
    max_new: int = 32
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Serves `Request`s with `params` (an `LM` on `device`) over a cache of
    `batch_slots` rows of `max_len` positions.  The cache is updated in
    place."""

    def __init__(self, params: tfm.LM, cfg: LMConfig, batch_slots: int,
                 max_len: int, device="cuda"):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params lie on {params.embed.device}, the "
                             f"batcher on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.cache = tfm.init_cache(cfg, batch_slots, max_len,
                                    params.embed.dtype, self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._next_tok = np.zeros(batch_slots, np.int32)

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request):
        if req.prompt.shape[0] >= self.max_len:
            raise ValueError(f"prompt of {req.prompt.shape[0]} tokens does "
                             f"not fit max_len {self.max_len}")
        self.queue.append(req)

    def _admit(self):
        """Fill free slots from the queue: prefill the prompt and splice its
        KV into the slot's rows of the batch cache."""
        for b in range(self.B):
            if self.slot_req[b] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            tokens = torch.from_numpy(
                np.asarray(req.prompt, np.int64)[None, :]).to(self.device)
            logits, pc = tfm.prefill(self.params, tokens, self.cfg,
                                     max_len=self.max_len)
            self.cache["k"][:, b] = pc["k"][:, 0]
            self.cache["v"][:, b] = pc["v"][:, 0]
            self.cache["len"][b] = req.prompt.shape[0]
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            self._next_tok[b] = tok
            self.slot_req[b] = req

    def _retire(self, b: int):
        self.slot_req[b].done = True
        self.slot_req[b] = None
        self.cache["len"][b] = 0

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """Admit waiting requests, run ONE decode step for every active
        slot, harvest finished requests.  Returns #active slots."""
        self._admit()
        active = [b for b in range(self.B) if self.slot_req[b] is not None]
        if not active:
            return 0
        tokens = torch.from_numpy(self._next_tok.astype(np.int64)).to(
            self.device)
        logits, self.cache = tfm.decode_step(self.params, self.cache, tokens,
                                             self.cfg)
        toks = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        lens = self.cache["len"].cpu().numpy()
        for b in active:
            req = self.slot_req[b]
            tok = int(toks[b])
            req.out.append(tok)
            self._next_tok[b] = tok
            if (len(req.out) >= req.max_new
                    or (req.eos_id is not None and tok == req.eos_id)
                    or int(lens[b]) >= self.max_len - 1):
                self._retire(b)
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
