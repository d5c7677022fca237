"""Device resolution, dtype casts and the tie rule shared by the port.

Tie rule: wherever the reference uses ``lax.top_k`` or ``argmax``, ties go
to the lowest index.  ``torch.topk`` promises no order among equal values
on CUDA, so every selection in the port goes through :func:`stable_topk`
(a stable descending sort) or :func:`first_argmax` (an explicit minimum
over the tied positions).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``cuda``; asking for CUDA without a card raises instead of
    running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def seeded_generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; ``None`` on
    the ``meta`` device, whose tensors hold no values (the dry run's
    parameters)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def as_f32(x, device) -> torch.Tensor:
    """``x`` as float32 on ``device`` (float64 input is narrowed)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def as_i32(x, device) -> torch.Tensor:
    """``x`` as int32 on ``device`` (int64 input is narrowed)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index.

    ``x [..., N]`` -> (vals [..., k] descending, pos [..., k] int64).  When
    ``N < k`` the tail is padded with ``-inf`` at position ``-1``.
    """
    n = x.shape[-1]
    if n < k:
        x = torch.cat([x, x.new_full((*x.shape[:-1], k - n), -torch.inf)],
                      dim=-1)
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    if n < k:
        pos = torch.where(pos < n, pos, -1)
    return vals, pos


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``)."""
    n = x.shape[-1]
    best = x.max(dim=-1, keepdim=True).values
    pos = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == best, pos, n).min(dim=-1).values
