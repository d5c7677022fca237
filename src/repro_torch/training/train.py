"""Train-step factory shared by the launcher, the smokes and the example.

Twin of ``src/repro/training/train.py``.  A step is
``(params, opt_state, batch) -> (params, opt_state, metrics)`` like the
reference's, with autograd in place of ``jax.value_and_grad`` and the
parameters and state updated in place (the reference donates them): the
returned ``params`` and ``opt_state`` are the objects passed in.  The step
marks every floating parameter as requiring grad while it runs, and drops
the gradients once they are applied.  ``grad_norm`` is the global norm
before the clip.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.training.optimizer import (OptConfig, global_norm, leaves,
                                            like_param, opt_update)
from repro_torch.utils import mesh_scope


def _params(params) -> list[torch.Tensor]:
    """Every floating leaf, marked as requiring grad, with no gradient."""
    out = [t for _, parts in leaves(params) for t in parts
           if t.is_floating_point()]
    for t in out:
        t.requires_grad_(True)
        t.grad = None
    return out


def _release(ps: list[torch.Tensor]) -> None:
    for p in ps:
        p.grad = None
        p.requires_grad_(False)


def _grads(tree, sums=None):
    """``tree`` with each leaf replaced by its gradient: ``sums[id(leaf)]``
    where given, else ``.grad`` (zeros where the loss did not reach it)."""
    if isinstance(tree, dict):
        return {k: _grads(v, sums) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grads(t, sums) for t in tree]
    if sums and id(tree) in sums:
        return sums[id(tree)]
    return (like_param(tree.grad, tree) if tree.grad is not None
            else torch.zeros_like(tree))


def _update(opt_cfg, params, opt_state, grads) -> torch.Tensor:
    norm = global_norm(grads)
    opt_update(opt_cfg, grads, opt_state, params, grad_norm=norm)
    return norm


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``.  Returns the step:
    ``(params, opt_state, batch) -> (params, opt_state, metrics)`` with
    the loss function's metrics, ``loss`` and the pre-clip ``grad_norm``
    (0-d tensors on the parameters' device)."""

    def train_step(params, opt_state, batch):
        ps = _params(params)
        with mesh_scope(params):
            loss, metrics = loss_fn(params, batch)
            loss.backward()
        norm = _update(opt_cfg, params, opt_state, _grads(params))
        _release(ps)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["grad_norm"] = norm
        return params, opt_state, out

    return train_step


def make_train_step_accum(loss_fn: Callable, opt_cfg: OptConfig,
                          n_micro: int):
    """Gradient accumulation over ``n_micro`` micro-batches (a loop in
    place of the reference's ``lax.scan``): every batch leaf's leading dim
    is split into ``n_micro`` equal parts, the gradients are summed in f32
    (in place in ``.grad`` for f32 parameters, in f32 buffers for the
    others), divided by ``n_micro`` and applied once.  Metrics: the mean
    ``loss`` and the pre-clip ``grad_norm``."""

    def train_step(params, opt_state, batch):
        ps = _params(params)
        n = next(iter(batch.values())).shape[0]
        if n % n_micro:
            raise ValueError(f"a batch of {n} over {n_micro} micro-batches")
        sums = {}                  # id of a non-f32 parameter -> f32 sum
        total = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        with mesh_scope(params):
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, n // n_micro, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _ = loss_fn(params, mb)
                loss.backward()
                total = total + loss.detach()
                for p in ps:
                    if p.dtype != torch.float32 and p.grad is not None:
                        if id(p) in sums:
                            sums[id(p)].add_(p.grad.float())
                        else:
                            sums[id(p)] = p.grad.float()
                        p.grad = None
            total = total / n_micro
        grads = _grads(params, sums)
        for _, parts in leaves(grads):
            for g in parts:
                g.div_(n_micro)
        norm = _update(opt_cfg, params, opt_state, grads)
        _release(ps)
        return params, opt_state, {"loss": total, "grad_norm": norm}

    return train_step
