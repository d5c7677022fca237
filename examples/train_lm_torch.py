"""Train an LM end to end on the PyTorch/CUDA port with the production loop
(checkpoints + watchdog).

    PYTHONPATH=src python examples/train_lm_torch.py            # ~20M, 200 steps
    PYTHONPATH=src python examples/train_lm_torch.py --full     # ~100M preset
    PYTHONPATH=src python examples/train_lm_torch.py --steps 5 --device cpu

The twin of ``examples/train_lm.py``: the same lm20m config (lm100m with
``--full``), batch, sequence, AdamW, Markov LM data, async atomic
checkpoints every 50 steps, straggler watchdog and resumable restarts
(re-run the command: it resumes), through
``repro_torch.launch.train.train_lm``, plus ``--device`` (default
``cuda``).  Its default checkpoint directory is its own, under the
system's temporary directory, so neither twin resumes the other's
checkpoints.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import make_lm100m, train_lm
from repro_torch.models.transformer import TransformerConfig

LM20M = TransformerConfig(
    name="lm20m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=1024, vocab_size=4096, d_head=32, remat=False)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slow on 1 CPU core)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full:
        cfg = make_lm100m()
        batch, seq = 4, 256
    else:
        cfg = LM20M
        batch, seq = 8, 128
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch={batch} seq={seq}")
    losses = train_lm(cfg, steps=args.steps, batch=batch, seq=seq,
                      ckpt_dir=args.ckpt_dir, log_every=20,
                      device=args.device)
    if not losses:
        print(f"nothing to train: the checkpoint in {args.ckpt_dir} is "
              f"already at step {args.steps}")
        return losses
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'check data'})")
    return losses


if __name__ == "__main__":
    main()
