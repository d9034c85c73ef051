"""Continuous-batching serving engine (the synchronous front-end).

A fixed pool of ``batch`` decode slots shares one decode step, so shapes
never change.  Requests queue up; a free slot is filled by prefilling the
prompt token by token through that same decode step; a finished sequence
(EOS, its token budget, or the end of the cache) frees its slot at once, so
the decode batch never drains.  This is the JAX package's ``ServingEngine``
with its synchronous ``run()``: the same slot bookkeeping, the same
greedy/sampled token choice, in eager PyTorch steps on the model's device.

The JAX engine's async front-end, chunked prefill, launch-plan tables, step
plans, bucket accounting, telemetry, driver warm start and
``tune_for_shape`` are not ported yet (ROADMAP Queue A, 'Rest of the
serving slice').
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .sampling import greedy, sample

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    output: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params: dict, batch: int, max_seq: int,
                 eos_id: int = 1, seed: int = 0):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = model.init_cache(batch, max_seq)
        self.slot_req: list[Request | None] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)      # next write position
        self.slot_last = np.zeros(batch, np.int32)     # last emitted token
        self.slot_budget = np.zeros(batch, np.int32)
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self.steps = 0                                 # decode steps run

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Fill free slots and decode until every request is done (or
        ``max_steps`` fill-and-decode rounds); returns finished requests."""
        rounds = 0
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and rounds < max_steps:
            self._fill_slots()
            self._decode_once()
            rounds += 1
        return self.finished

    # -- internals ------------------------------------------------------------
    def _step(self, tok: np.ndarray, ps: np.ndarray) -> torch.Tensor:
        token = torch.as_tensor(tok, device=self.device)
        pos = torch.as_tensor(ps, device=self.device)
        logits, self.cache = self.model.decode_step(self.params, token, pos,
                                                    self.cache)
        return logits

    def _fill_slots(self) -> None:
        for s in range(self.batch):
            if self.slot_req[s] is not None:
                continue
            if not self.pending:
                break
            req = self.pending.pop(0)
            # prefill the prompt through the shared decode step
            for t_idx, tok in enumerate(req.prompt[:-1]):
                self._single(s, tok, t_idx)
            self.slot_req[s] = req
            self.slot_pos[s] = len(req.prompt) - 1
            self.slot_last[s] = req.prompt[-1]
            self.slot_budget[s] = req.max_new_tokens

    def _single(self, slot: int, token: int, pos: int) -> None:
        """One prompt token of ``slot``; the other slots rewrite their own
        current position with their own last token, which is idempotent."""
        tok = np.array(self.slot_last, np.int32)
        ps = np.array(self.slot_pos, np.int32)
        tok[slot] = token
        ps[slot] = pos
        self._step(tok, ps)

    def _decode_once(self) -> None:
        active = [s for s in range(self.batch) if self.slot_req[s] is not None]
        if not active:
            return
        logits = self._step(self.slot_last, self.slot_pos)
        self.steps += 1
        temps = {r.temperature for r in self.slot_req if r is not None}
        greedy_tok = greedy(logits).cpu().numpy()
        sampled_tok = sample(logits, self.generator,
                             temperature=max(temps | {1.0})).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            nxt = int(greedy_tok[s] if req.temperature <= 0.0
                      else sampled_tok[s])
            req.output.append(nxt)
            self.slot_pos[s] += 1
            self.slot_last[s] = nxt
            self.slot_budget[s] -= 1
            if (nxt == self.eos_id or self.slot_budget[s] <= 0
                    or self.slot_pos[s] >= self.max_seq - 1):
                req.done = True
                self.finished.append(req)
                self.slot_req[s] = None   # freed: continuous batching
