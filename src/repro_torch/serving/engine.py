"""Batched LM serving engine: continuous-batching-lite over prefill/decode.

Counterpart of ``repro/serving/engine.py``, with its waves, left padding,
greedy ``argmax`` and stop rules: requests join a fixed number of slots in
waves; all prompts of a wave are left-padded with token 0 to the wave's
longest (the prompts attend to the pad tokens, as in the reference) and
prefilled together, then decoded one token a step until every request has
its ``max_new_tokens`` or emitted ``eos_id``. The engine runs eagerly on
``device`` (CUDA unless asked; there is no jit counterpart), and reads
each active slot's token back to the host every step, as the JAX engine
does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int = 16
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Slot-based batched decode. For simplicity all prompts in a refill
    wave are padded to the wave max and prefilled together."""

    def __init__(self, model: LM, params, batch_slots: int = 4,
                 max_seq: int = 128, eos_id: Optional[int] = None,
                 cache_dtype=torch.float32, device=None):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.queue: deque[Request] = deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests."""
        done: list[Request] = []
        while self.queue:
            wave = [self.queue.popleft()
                    for _ in range(min(self.slots, len(self.queue)))]
            done.extend(self._run_wave(wave))
        return done

    def _run_wave(self, wave: list[Request]) -> list[Request]:
        b = len(wave)
        max_prompt = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, max_prompt), np.int32)
        for i, r in enumerate(wave):
            toks[i, max_prompt - len(r.prompt):] = r.prompt  # left-pad
        cache = self.model.init_cache(b, self.max_seq, dtype=self.cache_dtype,
                                      device=self.device)
        tokens = torch.from_numpy(toks).to(self.device, torch.long)
        logits, cache = self.model.prefill(self.params, tokens, cache)
        budget = max(r.max_new_tokens for r in wave)
        cur = torch.argmax(logits, -1)[:, None]
        active = np.ones(b, bool)
        for _ in range(budget):
            for i, r in enumerate(wave):
                if active[i]:
                    t = int(cur[i, 0])
                    r.output.append(t)
                    if (self.eos_id is not None and t == self.eos_id) \
                            or len(r.output) >= r.max_new_tokens:
                        active[i] = False
                        r.done = True
            if not active.any():
                break
            logits, cache = self.model.decode_step(self.params, cache, cur)
            cur = torch.argmax(logits, -1)[:, None]
        for r in wave:
            r.done = True
        return wave
