"""Quick smoke of every architecture's serving path at its SMOKE config
(counterpart of `scripts/smoke_models.py` without its loss and grad
step, which belong to training): one prefill and, for each arch with a
decode path, one decode step into a cache grown past the prompt.

    PYTHONPATH=src python -m repro_torch.launch.smoke_models [--device cpu]

Runs on CUDA unless given `--device cpu`.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import batch_for
from repro_torch.launch.serve import grow_cache
from repro_torch.models import lm

B, S, GROW = 2, 16, 8


def smoke(arch: str, device, seed: int = 0) -> dict:
    """Prefill (and one decode step) of `arch`'s SMOKE config; fails
    unless every logit is finite. Returns the logits' shapes."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                            device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_for(cfg, B, S, 0, seed=seed).items()}
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, batch)
        out = {"prefill": tuple(logits.shape)}
        assert bool(torch.isfinite(logits.float()).all()), arch
        if cfg.has_decode:
            cache = grow_cache(cfg, cache, B, int(cache["len"]) + GROW)
            tok = torch.full((B, 1), 3, dtype=torch.int32, device=device)
            lg, cache = lm.decode_step(params, cfg, tok, cache)
            assert bool(torch.isfinite(lg.float()).all()), arch
            out["decode"] = tuple(lg.shape)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run "
                         "without a card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for arch in ARCH_IDS:
        results[arch] = smoke(arch, device, args.seed)
        line = f"{arch:20s} prefill logits={results[arch]['prefill']}"
        if "decode" in results[arch]:
            line += f" decode_ok logits={results[arch]['decode']}"
        print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
