"""Training entry point: real steps on one card, the production loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300 --ckpt-dir ck

The twin of ``repro/launch/train.py``: any registered arch at smoke scale
(the five LMs, the four recsys models, DimeNet) through the registry, or
the ~100M-param preset, with checkpoint/restore (atomic, async), the
straggler watchdog and the same printed lines, plus ``--device`` (default
``cuda``; ``cpu`` runs on the CPU).  ``--arch has-rag`` raises
``ValueError``: the paper's retrieval step has no train step (the
reference fails there too, unpacking its smoke's three values into five).

Checkpoints are flat mappings of named tensors (``params/layers/3/attn/wq``,
``opt/m/layers/attn/wq``, ``opt/step``).  On resume, ``train_lm`` draws and
drops the batches of the steps already taken, so a resumed run trains on
the batches an uninterrupted run would; the reference restarts its data
stream instead.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.utils import resolve_device, synchronize

def make_lm100m():
    """~100M-param dense transformer for the end-to-end training example."""
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name="lm100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab_size=8192, d_head=64, remat=False)


def _flat(tree, prefix: str) -> dict:
    """A tree of tensors (nested dicts and lists) as one flat mapping of
    ``prefix/key/.../leaf`` names (list elements by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def train_lm(cfg, steps: int, batch: int, seq: int, ckpt_dir: str | None,
             log_every: int = 10, seed: int = 0,
             device=None) -> list[float]:
    """Train ``cfg`` from ``init_master_params(cfg, seed)`` on the Markov
    source, f32 compute, AdamW (Adafactor for MoE), checkpoints every 50
    steps, resuming from the latest in ``ckpt_dir`` -> the losses of the
    steps run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.lm import MarkovLM
    from repro_torch.models import transformer as tf
    from repro_torch.training.fault import StragglerDetector
    from repro_torch.training.optimizer import OptConfig, opt_init
    from repro_torch.training.train import make_train_step

    dev = resolve_device(device)
    params = tf.init_master_params(cfg, seed=seed, device=dev)
    opt_cfg = OptConfig(name="adafactor" if cfg.is_moe else "adamw", lr=3e-4)
    opt_state = opt_init(opt_cfg, params)
    lossf = functools.partial(tf.loss_fn, cfg=cfg,
                              compute_dtype=torch.float32)
    step_fn = make_train_step(lossf, opt_cfg)

    def tree():
        # numpy has no bf16: bf16 leaves go through as views of their bits
        flat = {**_flat(params, "params"), **_flat(opt_state, "opt")}
        return {k: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                for k, t in flat.items()}

    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr:
        restored = mgr.restore_latest(tree())
        if restored is not None:
            start, saved = restored
            with torch.no_grad():
                for name, t in tree().items():
                    t.copy_(saved[name])
            print(f"[train] resumed from step {start}")

    lm = MarkovLM(cfg.vocab_size, order=2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(start):                 # the batches already trained on
        lm.sample(rng, batch, seq)
    detector = StragglerDetector()
    losses = []
    for step in range(start, steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in lm.sample(rng, batch, seq).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        synchronize(dev)
        elapsed = time.perf_counter() - t0
        if detector.observe(step, elapsed):
            print(f"[train] step {step}: straggler flagged "
                  f"({elapsed:.2f}s > {detector.deadline:.2f}s)")
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"{elapsed * 1e3:.0f} ms", flush=True)
        if mgr and (step + 1) % 50 == 0:
            mgr.save(step + 1, tree(), blocking=False)
    if mgr:
        mgr.wait()
        mgr.save(steps, tree(), blocking=True)
    return losses


def main(argv=None) -> list[float]:
    """The CLI; returns the losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="registered arch (smoke cfg)")
    ap.add_argument("--preset", default=None, choices=["lm100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    if args.preset == "lm100m":
        cfg = make_lm100m()
        print(f"[train] lm100m: {cfg.param_count() / 1e6:.1f}M params")
        return train_lm(cfg, args.steps, args.batch, args.seq, args.ckpt_dir,
                        device=args.device)

    from repro_torch.configs import all_archs, get_arch
    if args.arch not in all_archs():
        raise KeyError(f"unknown arch {args.arch!r}; the registered archs "
                       f"are {all_archs()}")
    spec = get_arch(args.arch)
    if spec.family == "rag":
        raise ValueError(f"{args.arch} is a retrieval step (family "
                         f"{spec.family!r}): it has no train step")
    cfg, params, opt_state, step, batch = spec.make_smoke(device=args.device)
    losses = []
    for i in range(args.steps):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"[train] {args.arch} step {i} loss {losses[-1]:.4f}")
    print("[train] done")
    return losses


if __name__ == "__main__":
    main()
