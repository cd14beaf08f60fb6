"""Batched serving engine: continuous batching over prefill/decode steps.

Port of ``repro.serve.engine`` on top of the port's transformer serving
primitives (:func:`repro_torch.models.transformer.prefill` and
:func:`~repro_torch.models.transformer.decode_step`):

* a slot-based KV cache: ``max_batch`` sequences decode in lock-step;
  finished slots are refilled from the request queue (continuous
  batching at fixed shapes);
* prefill runs per admitted request, its prompt left-padded with token 0
  to a multiple of ``prompt_pad`` (the pad tokens are attended), and its
  KV rows are copied into the slot of the decode cache **in place**;
* the decode step writes each slot's new K/V into that cache in place;
  empty slots decode too, with stale state, and their outputs are
  dropped;
* tokens are the first maximum of the logits (greedy ``argmax``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [L] int32
    max_new: int
    out: Optional[list] = None


class ServeEngine:
    """Continuous batching on the device of ``params``; ``attn`` names
    the attention implementation (``None``: the kernel on a CUDA device,
    the plain version on the CPU; see :func:`T.resolve_attn`)."""

    def __init__(self, cfg: T.LMConfig, params, *, max_batch: int = 8,
                 s_cache: int = 256, prompt_pad: int = 64,
                 eos_id: int = -1, attn=None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.attn = T.resolve_attn(attn, self.device)
        self.max_batch = max_batch
        self.s_cache = s_cache
        self.prompt_pad = prompt_pad
        self.eos = eos_id
        self.cache = T.init_cache(cfg, max_batch, s_cache, self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_remaining = np.zeros(max_batch, np.int64)
        self.cur_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self.queue: List[Request] = []
        self._prefill = lambda t: T.prefill(cfg, params, t, s_cache,
                                            attn=self.attn)
        self._decode = lambda c, t: T.decode_step(cfg, params, c, t,
                                                  attn=self.attn)

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            pad = self.prompt_pad - len(req.prompt) % self.prompt_pad
            pad = pad % self.prompt_pad
            prompt = np.pad(req.prompt, (pad, 0))[None, :]  # left pad
            cache, logits = self._prefill(
                torch.from_numpy(prompt.astype(np.int64)).to(self.device))
            # copy the prefilled KV rows into this slot, in place
            self.cache["k"][:, slot] = cache["k"][:, 0]
            self.cache["v"][:, slot] = cache["v"][:, 0]
            self.cache["pos"][slot] = cache["pos"][0]
            tok = torch.argmax(logits[0]).to(torch.int32)
            self.cur_tok[slot] = tok
            req.out.append(int(tok))
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new - 1

    def step(self):
        """One lock-step decode over all active slots."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return False
        logits, self.cache = self._decode(self.cache, self.cur_tok)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        self.cur_tok = nxt
        nxt_np = nxt.cpu().numpy()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.out.append(int(nxt_np[slot]))
            self.slot_remaining[slot] -= 1
            done = (self.slot_remaining[slot] <= 0 or
                    int(nxt_np[slot]) == self.eos)
            if done:
                self.slot_req[slot] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps
