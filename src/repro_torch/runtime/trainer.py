"""Fault-tolerant training loop: checkpoint/restart + deterministic data
(twin of `repro/runtime/trainer.py`).

The loop owns: periodic async checkpoints, failure recovery (restore latest
checkpoint + rewind the data cursor), and a failure-injection hook used by
the integration tests to prove end-state equivalence: a run interrupted by a
failure at step k and restarted MUST produce the same final params as an
uninterrupted run (bitwise, because data and init are deterministic).

The init takes a `torch.Generator` on `device` seeded with the run's seed
where the reference takes `jax.random.key(seed)`. With telemetry on
(`obs.session()`), each step is a `train.step` span (its `step` and, once
the host has read it, its `loss`), `train.steps` counts them and the
`train.params` gauge holds the number of parameters trained.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import obs as _obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.loader import ShardedLoader
from repro_torch.hw import resolve_device
from repro_torch.utils.tree import tree_count


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    restarts: int
    final_step: int
    losses: list


class FaultTolerantTrainer:
    def __init__(self, *, train_step: Callable, init_state: Callable,
                 dataset, ckpt_dir, checkpoint_every: int = 10,
                 keep: int = 3, device="cuda"):
        self.train_step = train_step
        self.init_state = init_state
        self.dataset = dataset
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.checkpoint_every = checkpoint_every
        self.device = resolve_device(device)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fresh(self, seed: int):
        state = self.init_state(self.generator(seed))
        loader = ShardedLoader(self.dataset)
        return state, loader

    def run(self, *, n_steps: int, seed: int = 0,
            fail_at_step: Optional[int] = None,
            max_restarts: int = 3) -> TrainerReport:
        restarts = 0
        losses = []
        state, loader = self._resume_or_fresh(seed)
        _obs.metrics.gauge_set("train.params", tree_count(state.params))
        steps_run = 0
        while int(state.step) < n_steps:
            try:
                if (fail_at_step is not None
                        and int(state.step) == fail_at_step):
                    fail_at_step = None  # fail once
                    raise SimulatedFailure(
                        f"injected failure at step {int(state.step)}")
                batch = next(loader)
                attrs = {"step": int(state.step)}
                with _obs.span("train.step", attrs):
                    state, metrics = self.train_step(state, batch)
                    attrs["loss"] = float(metrics["loss"])   # waits
                steps_run += 1
                _obs.metrics.inc("train.steps")
                losses.append(attrs["loss"])
                if int(state.step) % self.checkpoint_every == 0:
                    self.manager.save(
                        state, step=int(state.step),
                        extras={"loader": loader.state(), "seed": seed})
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                self.manager.wait()
                state, loader = self._resume_or_fresh(seed)
        self.manager.wait()
        return TrainerReport(steps_run=steps_run, restarts=restarts,
                             final_step=int(state.step), losses=losses)

    def _resume_or_fresh(self, seed: int):
        latest = self.manager.latest_step()
        if latest is None:
            return self._fresh(seed)
        template_state, loader = self._fresh(seed)
        state, manifest = self.manager.restore(template_state, step=latest)
        loader.restore(manifest["extras"]["loader"])
        return state, loader
