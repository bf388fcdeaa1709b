"""Sharding trees for TrainState (params + optimizer state) and caches
(twin of `repro/sharding/state.py`).

Optimizer-state axes derive structurally from param axes:
  adamw:     mu/nu mirror params
  adafactor: vr drops the last dim's axis; vc drops the second-to-last
  sgdm:      m mirrors params
so FSDP/TP sharding of a param automatically ZeRO-shards its state.

The port's param tree holds a stacked subtree as a list of per-layer
trees (`models.model.STACK_DEPTH`), so its axes tree does too (a layer's
leaf has the reference's axes less the leading "layers"); Adafactor's
state keeps the reference's stacked layout (`optim.optimizers`), so its
axes are the stacked ones (`stack_axes`).
"""

from __future__ import annotations

from repro_torch.sharding.rules import (NamedSharding, P, ShardingRules,
                                        distribute, is_axes, logical_to_spec,
                                        map_axes, rules_for_mesh)
from repro_torch.train.step import TrainState


def stack_axes(axes_tree):
    """The reference's stacked axes of a port axes tree: every list of
    per-layer trees becomes one tree with "layers" in front of each
    leaf."""
    if is_axes(axes_tree):
        return axes_tree
    if isinstance(axes_tree, dict):
        return {k: stack_axes(v) for k, v in axes_tree.items()}
    return map_axes(lambda a: ("layers",) + a, stack_axes(axes_tree[0]))


def optimizer_state_axes(opt_name: str, param_axes, params_abs=None):
    """The optimizer state's axes tree for a param axes tree (a leaf's
    rank is its axes' length, so `params_abs` is not read; it is kept
    for the reference's signature)."""
    if opt_name == "adamw":
        return {"mu": param_axes, "nu": param_axes, "count": ()}
    if opt_name == "sgdm":
        return {"m": param_axes}
    if opt_name == "adafactor":
        def one(axes):
            if len(axes) >= 2:
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}

        return {"f": map_axes(one, stack_axes(param_axes)), "count": ()}
    raise ValueError(f"unknown optimizer {opt_name!r}")


def train_state_axes(model, optimizer, state_abs: TrainState):
    param_axes = model.param_axes()
    opt_axes = optimizer_state_axes(optimizer.name, param_axes,
                                    state_abs.params)
    return TrainState(params=param_axes, opt_state=opt_axes, step=())


def axes_to_shardings(axes_tree, abs_tree, mesh,
                      rules: ShardingRules | None = None):
    rules = rules or rules_for_mesh(mesh)

    def one(axes, arr):
        return NamedSharding(mesh, logical_to_spec(axes, arr.shape, mesh,
                                                   rules))

    return map_axes(one, axes_tree, abs_tree)


def distribute_tree(tree, shardings):
    """Every tensor of `tree` as a DTensor of its sharding (`shardings`
    has the tree's structure; `rules.distribute`)."""
    if isinstance(shardings, NamedSharding):
        return distribute(tree, shardings)
    if isinstance(shardings, dict):
        return {k: distribute_tree(tree[k], v) for k, v in shardings.items()}
    if isinstance(shardings, list):
        return [distribute_tree(t, s) for t, s in zip(tree, shardings)]
    return TrainState(**{k: distribute_tree(getattr(tree, k),
                                            getattr(shardings, k))
                         for k in ("params", "opt_state", "step")})


def batch_axes(batch_abs):
    """Input-batch logical axes: leading dim is always the global batch."""
    return {k: ("batch",) + (None,) * (x.ndim - 1)
            for k, x in batch_abs.items()}


def replicated(mesh):
    return NamedSharding(mesh, P())
