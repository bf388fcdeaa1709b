"""Optimizers as (init, update) pairs over param trees (twin of
`repro/optim/optimizers.py`), in the reference's arithmetic op for op.

AdamW for small/medium archs; Adafactor (factored second moment, optional
momentum) for the 100B+ archs where full Adam state triples HBM.
`torch.optim` is not used: its decoupled weight decay and its order of
operations round differently.

A param tree is the port's: a model's `layers` are a list of per-layer
trees, where the reference holds one stacked (L, ...) leaf per name.
AdamW and SGDM are elementwise, so their state mirrors the port's tree.
Adafactor's statistics are not: its update-RMS clip is taken over the
whole stacked leaf, and a per-layer 1-D leaf is a 2-D (L, d) leaf there,
factored with one `vc` shared by the layers. So Adafactor stacks each
list of layer trees by name (`stack_layers`), keeps its state in the
reference's stacked layout and splits the updates back per layer.

The moments of AdamW and SGDM are written in place: the state `update`
returns holds the same tensors as the one it was given (one state's
moments at a time in device memory: 15 GB at 1.9B parameters).
Counters and learning rates are 0-d float32 / int32 tensors on the
params' device, so no step waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.utils.tree import (flatten_up_to, tree_leaves, tree_map,
                                    unflatten)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable            # params -> opt_state
    # (grads, opt_state, params, lr) -> (updates, opt_state)
    update: Callable
    name: str = "opt"


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, each cast back
    to its own dtype; the norm before clipping, float32)."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    gnorm = torch.sqrt(sum(leaves))
    scale = torch.clamp(gnorm.new_tensor(max_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw(*, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)

        return {"mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        neg_lr = -lr

        def upd(g, mu, nu, p):
            g32 = g.float()
            mu.mul_(b1).add_((1 - b1) * g32)
            nu.mul_(b2).add_((1 - b2) * torch.square(g32))
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            step = mu_hat / (torch.sqrt(nu_hat) + eps)
            step = step + weight_decay * p.float()
            return (neg_lr * step).to(p.dtype)

        updates = tree_map(upd, grads, state["mu"], state["nu"], params)
        return updates, {"mu": state["mu"], "nu": state["nu"],
                         "count": count}

    return Optimizer(init=init, update=update, name="adamw")


def stack_layers(tree, stack=torch.stack):
    """The reference's layout of a param-shaped tree: every list of
    per-layer trees becomes one tree of stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: stack_layers(v, stack) for k, v in tree.items()}
    if isinstance(tree, list):
        layers = [stack_layers(t, stack) for t in tree]
        return tree_map(lambda *xs: stack(xs), *layers)
    return tree


def unstack_layers(tree, like):
    """`stack_layers` undone: the (L, ...) leaves of `tree` split into
    `like`'s lists of per-layer trees."""
    if isinstance(like, dict):
        return {k: unstack_layers(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [unstack_layers(tree_map(lambda x: x[i], tree), t)
                for i, t in enumerate(like)]
    return tree


def _stacked_view(xs):
    """A stand-in with the stacked leaf's shape, dtype and device; no
    copy (for the init, which reads only those)."""
    return xs[0].detach().expand(len(xs), *xs[0].shape)


def adafactor(*, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              momentum: Optional[float] = None) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified).

    2D+ leaves (of the stacked layout) keep row/col second-moment vectors
    (O(n+m) state instead of O(n*m)); 1D leaves keep a full vector.
    Optional bf16 first moment. The state is the reference's, stacked
    (L, ...) under the layer lists' names.
    """
    def init(params):
        def one(p):
            if p.ndim >= 2:
                st = {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                        device=p.device),
                      "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                        dtype=torch.float32,
                                        device=p.device)}
            else:
                st = {"v": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)}
            if momentum is not None:
                st["m"] = torch.zeros(p.shape, dtype=torch.bfloat16,
                                      device=p.device)
            return st

        return {"f": tree_map(one, stack_layers(params, _stacked_view)),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        beta2 = 1.0 - c ** (-decay)

        def one(g, st, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if p.ndim >= 2:
                vr = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.mean(vr, dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., None]
                u = g32 * torch.rsqrt(torch.clamp(r * vc[..., None, :],
                                                  min=eps))
                new = {"vr": vr, "vc": vc}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                u = g32 * torch.rsqrt(torch.clamp(v, min=eps))
                new = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / rms.new_tensor(clip_threshold),
                                min=1.0)
            if momentum is not None:
                m = momentum * st["m"].float() + (1 - momentum) * u
                new["m"] = m.to(torch.bfloat16)
                u = m
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype), new

        g_st, p_st = stack_layers(grads), stack_layers(params)
        g_leaves = tree_leaves(g_st)
        results = [one(g, s, p) for g, s, p in zip(
            g_leaves, flatten_up_to(g_st, state["f"]), tree_leaves(p_st))]
        updates = unflatten(g_st, [r[0] for r in results])
        new_f = unflatten(g_st, [r[1] for r in results])
        return (unstack_layers(updates, grads),
                {"f": new_f, "count": count})

    return Optimizer(init=init, update=update, name="adafactor")


def sgdm(*, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        neg_lr = -lr

        def one(g, m, p):
            m.mul_(momentum).add_(g.float())
            return (neg_lr * m).to(p.dtype)

        return tree_map(one, grads, state["m"], params), {"m": state["m"]}

    return Optimizer(init=init, update=update, name="sgdm")


@torch.no_grad()
def apply_updates(params, updates):
    """Adds each update into its param in place (`p.add_(u)`: the bits of
    the reference's `p + u.astype(p.dtype)`) and returns the params."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
