"""Training step: loss -> grad -> clip -> optimizer, with optional
microbatch gradient accumulation (one weight update per global batch;
twin of `repro/train/step.py`).

The model holds its weights (`models.model.DecoderLM`), so a
`TrainState`'s params are the model's own Parameters (`param_tree()`):
the step differentiates `model.loss(batch)` with respect to them and adds
the updates into them in place, and the optimizer writes its moments in
place, so the state a step returns holds the same tensors as the one it
was given. A state whose params are other tensors (one restored from a
checkpoint) is copied into the model first. The step counter and the
optimizer's count are 0-d int32 tensors on the model's device.

With telemetry on (`obs.session()`), a step's loss and gradient are a
`train.grads` span and its clip, optimizer and weight update a
`train.update` span, each ending when the device has done its work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.optim import optimizers as _opt
from repro_torch.utils.tree import tree_leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor


def default_optimizer_for(cfg) -> _opt.Optimizer:
    """AdamW below ~10B params; Adafactor above (state must fit HBM)."""
    big = cfg.n_layers * cfg.d_model * cfg.d_model > 40e9 or \
        (cfg.moe_n_experts > 0 and cfg.d_model >= 4096)
    return _opt.adafactor() if big else _opt.adamw()


def make_train_state_init(model, optimizer: _opt.Optimizer):
    """init(generator) -> TrainState: the model's weights drawn anew from
    the `torch.Generator` (on the model's device), fresh optimizer state,
    step 0."""
    def init(generator: torch.Generator):
        params = model.init(generator)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=model.device))
    return init


def to_device(batch, device):
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def value_and_grad(model, batch):
    """(loss, metrics, grads): the loss of `batch` (tensors on the
    model's device) and its gradient as a tree of `model.param_tree()`'s
    structure, each in its param's dtype."""
    params = model.param_tree()
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(model, optimizer: _opt.Optimizer, *,
                    schedule: Optional[Callable] = None,
                    grad_clip: float = 1.0,
                    n_microbatches: int = 1,
                    accum_dtype=torch.float32):
    """Returns train_step(state, batch) -> (state, metrics {'loss',
    'grad_norm', 'lr'}). With n_microbatches > 1 the batch is split along
    its first axis, the grads summed in `accum_dtype` and divided by n, so
    the grads that reach the clip and the optimizer are `accum_dtype`;
    with one they keep the params' dtype, as in the reference."""
    if schedule is None:
        schedule = lambda step: torch.tensor(  # noqa: E731
            3e-4, dtype=torch.float32, device=step.device)

    def train_step(state: TrainState, batch):
        params = model.load_params(state.params)
        batch = to_device(batch, model.device)
        with _obs.span("train.grads"):
            if n_microbatches > 1:
                per = next(iter(batch.values())).shape[0] // n_microbatches
                # zeros_like: a sharded param's sum is sharded as it is
                gsum = tree_map(lambda p: torch.zeros_like(
                    p, dtype=accum_dtype), params)
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for i in range(n_microbatches):
                    micro = {k: v[i * per:(i + 1) * per]
                             for k, v in batch.items()}
                    loss, _, grads = value_and_grad(model, micro)
                    tree_map(lambda a, g: a.add_(g.to(accum_dtype)), gsum,
                             grads)
                    lsum = lsum + loss
                    del grads
                n = lsum.new_tensor(n_microbatches)
                grads = tree_map(lambda g: g / n.to(g.dtype), gsum)
                del gsum
                loss = lsum / n
            else:
                loss, _, grads = value_and_grad(model, batch)
            _obs.maybe_block(loss)

        with _obs.span("train.update"):
            grads, gnorm = _opt.clip_by_global_norm(grads, grad_clip)
            lr = schedule(state.step)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  params, lr)
            del grads
            params = _opt.apply_updates(params, updates)
            _obs.maybe_block(gnorm)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    return train_step
