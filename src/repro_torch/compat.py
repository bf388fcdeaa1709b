"""Hand the reference package's numpy arrays to the port.

`np.asarray` of a JAX array is read-only, and `torch.from_numpy` warns on
(and would alias) such an array, so read-only inputs are copied.
`lm_params_from_reference` carries an LM's weights across.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _tensor_tree(specs, arrays, device, layer=None):
    from repro_torch.models import nn
    return {k: (_tensor(arrays[k] if layer is None else arrays[k][layer],
                        spec.dtype, device) if nn.is_spec(spec)
                else _tensor_tree(spec, arrays[k], device, layer))
            for k, spec in specs.items()}


def lm_params_from_reference(cfg, params, *, device):
    """A `models.model.DecoderLM` on `device` holding the reference's
    weights: `params` is the reference model's param tree as numpy arrays
    (layers stacked (L, ...)), in the config's dtype. The port keeps the
    reference's (d_in, d_out) layout, so the weights are copies and the
    model computes the same function."""
    from repro_torch.hw import resolve_device
    from repro_torch.models import model
    dev = resolve_device(device)
    specs = model.param_specs(cfg)
    arrays = _float_tree(specs, params)
    tree = {k: _tensor_tree(specs[k], arrays[k], dev)
            for k in ("embed", "final_norm", "unembed")}
    tree["layers"] = [_tensor_tree(specs["layers"], arrays["layers"], dev,
                                   layer=l) for l in range(cfg.n_layers)]
    return model.DecoderLM(cfg, device=dev, params=tree)
