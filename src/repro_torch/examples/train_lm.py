"""End-to-end driver: train a ~110M-parameter LM for a few hundred
steps with the full stack -- deterministic data pipeline, AdamW, async
checkpointing, crash recovery.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \
        [--device cpu]

Counterpart of `examples/train_lm.py`, on CUDA unless `--device cpu`.
Optionally inject a failure to watch recovery:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 60 \
        --fault-at 35
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.examples._cli import Out
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig

# ~110M params: a qwen2-family config between the smoke and full sizes.
CONFIG_110M = ArchConfig(
    name="repro-110m",
    family="dense",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=2,
    d_ff=2560,
    vocab=32000,
    head_dim=64,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    tie_embeddings=True,
    source="this repo (scaled qwen2 family)",
)


def main(argv=None) -> dict:
    """Trains; returns the final state and the printed lines."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_110m"))
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; \"cpu\" to run "
                         "without a card)")
    args = ap.parse_args(argv)
    say = Out()

    total, _ = lm.param_counts(CONFIG_110M)
    say(f"model: {CONFIG_110M.name}, {total / 1e6:.1f}M params")

    tc = TrainerConfig(batch=args.batch, seq=args.seq, ckpt_every=50,
                       log_every=10, fault_at_step=args.fault_at,
                       warmup_steps=20, total_steps=args.steps,
                       opt=AdamWConfig(lr=1e-3, weight_decay=0.01))
    trainer = Trainer(CONFIG_110M, args.workdir, tc, device=args.device)
    state = (trainer.run_with_recovery(args.steps)
             if args.fault_at is not None else trainer.run(args.steps))
    say(f"finished at step {int(state.step)}; "
        f"metrics in {trainer.metrics_path}")
    # Show the loss trajectory.
    with open(trainer.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    first, last = recs[0], recs[-1]
    say(f"loss: step {first['step']} -> {first['loss']:.4f} ... "
        f"step {last['step']} -> {last['loss']:.4f}")
    return {"state": state, "lines": say.lines}


if __name__ == "__main__":
    main()
