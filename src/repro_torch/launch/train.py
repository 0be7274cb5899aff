"""Training launcher (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 200 --workdir /tmp/run1 [--device cpu]

Trains on one device, CUDA unless given `--device cpu`; prefill-style
attention and the Mamba2 scan run the port's CUDA kernels there, with
gradients through their autograd Functions. `--smoke` takes the reduced
(SMOKE) config. `--fault-at` injects a failure and recovers from the
latest checkpoint. The reference's pod-local sync (`--hier`,
`--compress`) waits for the `parallel/` port (ROADMAP.md queue 1 item
7) and raises a ValueError.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    """Runs the launcher; returns the final train state."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (SMOKE) config")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--hier", type=int, default=0, metavar="T_POD",
                    help="pod-local sync period (0 = plain data parallel)")
    ap.add_argument("--n-pods", type=int, default=2)
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod delta exchange (with --hier)")
    ap.add_argument("--fault-at", type=int, default=None,
                    help="inject a failure at this step (recovery demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; \"cpu\" to run "
                         "without a card)")
    args = ap.parse_args(argv)
    if args.hier or args.compress:
        raise ValueError("--hier / --compress (pod-local sync) need the "
                         "parallel/ port: ROADMAP.md queue 1 item 7")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainerConfig(batch=args.batch, seq=args.seq,
                       ckpt_every=args.ckpt_every, remat=args.remat,
                       seed=args.seed, fault_at_step=args.fault_at)
    trainer = Trainer(cfg, args.workdir, tc, device=args.device)
    state = (trainer.run_with_recovery(args.steps)
             if args.fault_at is not None else trainer.run(args.steps))
    print(f"[train] finished at step {int(state.step)}; "
          f"metrics: {trainer.metrics_path}")
    return state


if __name__ == "__main__":
    main()
