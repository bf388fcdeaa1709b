"""Serving an LM: the decode and prefill steps and a host-side loop with
continuous batching (twin of `repro/serve/engine.py`): finished sequences
are replaced in place, so the device batch shape never changes.

The model holds its weights, so the reference's `params` arguments are
gone, and a `torch.Generator` on the model's device replaces the JAX key
(`run(generator=)`). Samplers take `(logits (B, 1, V), generator)` and
return (B,) int32 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs


def greedy_sample(logits, generator=None):
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def temperature_sample(temperature: float = 0.8):
    def sample(logits, generator):
        # the Gumbel-max draw of the categorical, as jax.random.categorical:
        # argmax(x / T + G), G = -log(E) with E ~ Exp(1)
        scaled = logits[:, -1, :] / max(temperature, 1e-4)
        e = torch.empty_like(scaled).exponential_(generator=generator)
        return torch.argmax(scaled - e.log(), dim=-1).to(torch.int32)
    return sample


def make_serve_step(model, *, sampler: Optional[Callable] = None):
    """serve_step(token, caches, cache_len, generator)
    -> (next_token (B, 1), logits, caches): one new token against the KV
    cache."""
    sampler = sampler or greedy_sample

    def serve_step(token, caches, cache_len, generator):
        logits, caches = model.decode_step(token, caches, cache_len)
        nxt = sampler(logits, generator)
        return nxt[:, None], logits, caches

    return serve_step


def make_prefill(model):
    def prefill(batch, max_len):
        return model.prefill(batch, max_len=max_len)
    return prefill


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 32
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Host-side continuous-batching driver over the decode step.

    Slots hold independent sequences; when one finishes, the next queued
    request takes its slot, so the device batch shape never changes.

    As in the reference, every slot decodes at one shared cache_len (the
    longest slot's length), and a slot taken over by a new request keeps
    the cache columns of its previous occupant: a late-admitted request
    attends to [0, cache_len) of them. Where the caches are recurrent
    states (hybrid, xLSTM), admission resets nothing either: the new
    request continues from the previous occupant's state. The port
    reproduces this so that its tokens equal the reference's.
    """

    def __init__(self, model, *, batch_size: int, max_len: int,
                 sampler=None, eos_id: Optional[int] = None):
        self.model = model
        self.device = model.device
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.step_fn = make_serve_step(model, sampler=sampler)
        self.caches = model.init_caches(batch=batch_size, max_len=max_len)
        self.slots: list[Optional[Request]] = [None] * batch_size
        self.slot_len = np.zeros(batch_size, np.int32)
        self.tokens = np.zeros((batch_size, 1), np.int32)

    def _admit(self, queue: list[Request]):
        for i in range(self.batch):
            if self.slots[i] is None and queue:
                req = queue.pop(0)
                self.slots[i] = req
                _obs.metrics.inc("serve.requests_admitted")
                # the prompt is fed one token at a time
                self.slot_len[i] = 0
                self.tokens[i, 0] = req.prompt[0]
                req._prompt_pos = 1

    @torch.inference_mode()
    def run(self, requests: list[Request], *, max_steps: int = 256,
            generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        queue = list(requests)
        self._admit(queue)
        steps = 0
        while steps < max_steps and (queue or any(
                s is not None for s in self.slots)):
            with _obs.span("serve.step", {"step": steps}):
                active_len = int(self.slot_len.max()) if len(
                    self.slot_len) else 0
                nxt, _, self.caches = self.step_fn(
                    torch.from_numpy(self.tokens).to(self.device),
                    self.caches, active_len, generator)
                # the copy to the host waits for the step: keep it inside
                # the span
                nxt = nxt.cpu().numpy()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                self.slot_len[i] += 1
                if req._prompt_pos < len(req.prompt):
                    self.tokens[i, 0] = req.prompt[req._prompt_pos]
                    req._prompt_pos += 1
                else:
                    tok = int(nxt[i, 0])
                    req.generated.append(tok)
                    self.tokens[i, 0] = tok
                    if (len(req.generated) >= req.max_new_tokens
                            or (self.eos_id is not None
                                and tok == self.eos_id)
                            or self.slot_len[i] >= self.max_len - 1):
                        req.done = True
                        self.slots[i] = None
                        self.slot_len[i] = 0
                        _obs.metrics.inc("serve.requests_completed")
            self._admit(queue)
            steps += 1
        _obs.metrics.inc("serve.steps", steps)
        return requests
