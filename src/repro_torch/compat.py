"""Hand the reference package's numpy arrays to the port.

`np.asarray` of a JAX array is read-only, and `torch.from_numpy` warns on
(and would alias) such an array, so read-only inputs are copied.
`lm_params_from_reference` carries an LM's weights across,
`train_state_from_reference` a training state (weights, optimizer state,
step), so both packages start a step from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def from_reference(dm=None, grouping=None, perms=None, *, device):
    """(dm f32, grouping int32, perms int32) as tensors on `device`; an
    argument left as None stays None."""
    return (None if dm is None else _tensor(dm, torch.float32, device),
            None if grouping is None else _tensor(grouping, torch.int32,
                                                  device),
            None if perms is None else _tensor(perms, torch.int32, device))


def _float_tree(specs, ref, path=""):
    """The reference's subtree as float32 numpy arrays, each checked
    against its spec's shape (bf16 leaves widen exactly)."""
    from repro_torch.models import nn
    out = {}
    for k, spec in specs.items():
        if k not in ref:
            raise KeyError(f"reference params lack {path}{k}")
        if nn.is_spec(spec):
            a = np.asarray(ref[k], dtype=np.float32)
            if a.shape != tuple(spec.shape):
                raise ValueError(f"{path}{k}: shape {a.shape}, the spec "
                                 f"says {tuple(spec.shape)}")
            out[k] = a
        else:
            out[k] = _float_tree(spec, ref[k], f"{path}{k}/")
    return out


def _tensor_tree(specs, arrays, device):
    from repro_torch.models import nn
    if nn.is_spec(specs):
        return _tensor(arrays, specs.dtype, device)
    return {k: _tensor_tree(spec, arrays[k], device)
            for k, spec in specs.items()}


def _split_layers(fn, tree, depth: int):
    """A stacked numpy tree (`depth` stacked dims) as nested lists of
    per-layer trees, each passed through `fn`."""
    if depth == 0:
        return fn(tree)
    n = np.asarray(tree_leaves(tree)[0]).shape[0]
    return [_split_layers(fn, tree_map(lambda a, i=i: np.asarray(a)[i],
                                       tree), depth - 1)
            for i in range(n)]


def _param_tree(cfg, params, dev) -> dict:
    """The reference's param tree (numpy, layers stacked) as the port's
    (each stacked subtree a list of per-layer trees, nested for a stack
    of stacks), each leaf checked against its spec and in its spec's
    dtype."""
    from repro_torch.models import model, nn
    specs = model.param_specs(cfg)
    arrays = _float_tree(specs, params)
    tree = {}
    for k, spec in specs.items():
        depth = model.STACK_DEPTH.get(k, 0)
        one, _ = nn.unstack_specs(spec, depth)
        tree[k] = _split_layers(
            lambda a, one=one: _tensor_tree(one, a, dev), arrays[k], depth)
    return tree


def lm_params_from_reference(cfg, params, *, device):
    """The port's model of `cfg`'s family (`models.model.build_model`) on
    `device` holding the reference's weights: `params` is the reference
    model's param tree as numpy arrays (layers stacked (L, ...)), in the
    config's dtype. The port keeps the reference's (d_in, d_out) layout,
    so the weights are copies and the model computes the same
    function."""
    from repro_torch.hw import resolve_device
    from repro_torch.models import model
    dev = resolve_device(device)
    return model.build_model(cfg, device=dev,
                             params=_param_tree(cfg, params, dev))


def _leaf(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype; an ml_dtypes bfloat16
    array (np.asarray of a JAX bf16 array) widens exactly through f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _tensor(a.astype(np.float32), torch.bfloat16, device)
    return _tensor(a, None, device)


def _per_layer(tree, device) -> dict:
    """A param-shaped numpy tree of the reference (layers stacked) in the
    port's layout: each stacked subtree split into (nested) lists of
    per-layer trees."""
    from repro_torch.models import model
    return {k: _split_layers(lambda t: tree_map(lambda a: _leaf(a, device),
                                                t),
                             v, model.STACK_DEPTH.get(k, 0))
            for k, v in tree.items()}


def train_state_from_reference(cfg, state, *, device):
    """The port's `train.step.TrainState` on `device` from the
    reference's, as numpy (`jax.tree.map(np.asarray, state)`): the
    stacked params (checked against the specs, in the config's dtype),
    the optimizer state and the step. AdamW's `mu` / `nu` and SGDM's `m`
    are split per layer like the params; Adafactor's `f` stays stacked,
    the layout its statistics need (`optim.optimizers.stack_layers`).
    The params are fresh tensors: the first step copies them into the
    model it trains."""
    from repro_torch.hw import resolve_device
    from repro_torch.train.step import TrainState
    dev = resolve_device(device)
    ref = state.opt_state
    opt_state = {}
    for k, v in ref.items():
        if k in ("mu", "nu", "m"):
            opt_state[k] = _per_layer(v, dev)
        else:       # Adafactor's stacked 'f', a 'count'
            opt_state[k] = tree_map(lambda a: _leaf(a, dev), v)
    return TrainState(params=_param_tree(cfg, state.params, dev),
                      opt_state=opt_state,
                      step=_leaf(state.step, dev))
