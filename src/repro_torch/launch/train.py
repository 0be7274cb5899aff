"""Training launcher (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 200 --workdir /tmp/run1 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 20 --hier 2 --compress [--device cpu]

Trains on one device, CUDA unless given `--device cpu`; prefill-style
attention and the Mamba2 scan run the port's CUDA kernels there, with
gradients through their autograd Functions. `--smoke` takes the reduced
(SMOKE) config. `--fault-at` injects a failure and recovers from the
latest checkpoint. `--hier T_POD` trains `--n-pods` pod-local replicas
that sync every T_POD steps (`parallel.hierarchical`; the pods run one
after another on the device, no checkpoints), `--compress` makes the
sync an int8 delta exchange with error feedback.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    """Runs the launcher; returns the final train state (a `HierState`
    with `--hier`)."""
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
    if args.compress and not args.hier:
        raise ValueError("--compress is the pod-local sync's int8 "
                         "exchange: it needs --hier T_POD")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.hier:
        return run_hier(cfg, args)
    tc = TrainerConfig(batch=args.batch, seq=args.seq,
                       ckpt_every=args.ckpt_every, remat=args.remat,
                       seed=args.seed, fault_at_step=args.fault_at)
    trainer = Trainer(cfg, args.workdir, tc, device=args.device)
    state = (trainer.run_with_recovery(args.steps)
             if args.fault_at is not None else trainer.run(args.steps))
    print(f"[train] finished at step {int(state.step)}; "
          f"metrics: {trainer.metrics_path}")
    return state


def run_hier(cfg, args):
    """Pod-local hierarchical training on one device: the pod axis is a
    leading tensor dim and the pods run in turn. Prints the loss every
    10 steps; returns the final `HierState`."""
    import torch

    from repro_torch.core.engine import resolve_device
    from repro_torch.data import batch_for
    from repro_torch.parallel.hierarchical import (build_hier_train_step,
                                                   init_hier_state)

    n_pods, T_pod, B = args.n_pods, args.hier, args.batch
    if B % n_pods:
        raise ValueError(f"--batch {B} does not split over --n-pods "
                         f"{n_pods}")
    device = resolve_device(args.device)
    state = init_hier_state(
        cfg, torch.Generator(device=device).manual_seed(args.seed), n_pods,
        compress=args.compress, device=device)
    step_fn = build_hier_train_step(cfg, n_pods, T_pod,
                                    compress=args.compress, remat=args.remat)
    for step in range(args.steps):
        batch = batch_for(cfg, B, args.seq, step, seed=args.seed)
        batch_p = {k: torch.from_numpy(x.reshape((n_pods, B // n_pods)
                                                 + x.shape[1:])).to(device)
                   for k, x in batch.items()}
        state, metrics = step_fn(state, batch_p)
        if step % 10 == 0:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"synced={int(metrics['synced'])}")
    print("[train/hier] done")
    return state


if __name__ == "__main__":
    main()
