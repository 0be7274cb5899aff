"""Serving launcher: prefill a prompt batch, then decode tokens with the
versioned parameter store (the paper's DC transplant) guarding weight
swaps against in-flight readers. Counterpart of `repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --batch 4 --prompt-len 16 --decode 32 [--device cpu]

Serves every arch with a decode path (an encoder such as hubert-xlarge
exits, as the reference's launcher does). Runs on CUDA unless given
`--device cpu`. Prefill attention and the Mamba2 scan go through the
port's CUDA kernels there.
"""
from __future__ import annotations

import argparse
import threading
import time

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import lm
from repro_torch.serve import (VersionedStore, build_decode_step,
                               build_prefill_step)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grow_cache(cfg, cache, B: int, total: int):
    """The prefill cache copied into a zeroed cache for `total`
    positions (the reference's right-sizing for decode growth): every
    layout's sequence axis grows, the other axes are equal."""
    full = lm.make_cache(cfg, B, total, device=cache["len"].device)
    for name, t in cache.items():
        if t.dim():
            full[name][tuple(slice(0, n) for n in t.shape)] = t
        else:
            full[name] = t.clone()
    return full


def generate(cfg, store: VersionedStore, batch: dict, n_new: int,
             *, swap_every: int = 0, background_swap: bool = False):
    """Prefill `batch` ("tokens" [B, S], plus a VLM's "patches") under a
    reader view into a cache of n_patches + S + n_new positions, then
    decode greedily until each row has `n_new` new tokens (the first
    from the prefill's logits), reading the params through worker
    `step % n_workers`'s view.
    Every `swap_every` decode steps the store swaps in the same params
    (a new version), inline or, with `background_swap`, from a thread
    that runs while the readers decode.

    Returns (new tokens [B, n_new] int32, prefill seconds, decode
    seconds for the n_new - 1 decode steps)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    prefill = build_prefill_step(cfg)
    decode = build_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    with store.reader_view(0) as (p, _):
        logits, cache = prefill(p, batch)
    cache = grow_cache(cfg, cache, B, cfg.n_patches + S + n_new)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out, swappers = [tok], []
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        if swap_every and (i + 1) % swap_every == 0:
            if background_swap:
                swappers.append(threading.Thread(
                    target=store.swap, args=(store._params,)))
                swappers[-1].start()
            else:
                store.swap(store._params)
        with store.reader_view(i % store.n_workers) as (p, _):
            tok, cache = decode(p, tok, cache)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    for th in swappers:
        th.join()
    return torch.cat(out, dim=1), prefill_s, decode_s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--swap-every", type=int, default=0,
                    help="swap weights every k decode steps (store demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run "
                         "without a card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import batch_for

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    B, S = args.batch, args.prompt_len

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device)
    store = VersionedStore(params, n_workers=1, T_DC=1)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_for(cfg, B, S, 0, seed=args.seed).items()}
    toks, prefill_s, decode_s = generate(cfg, store, batch, args.decode,
                                         swap_every=args.swap_every)
    steps = args.decode - 1
    prefix = f" after {cfg.n_patches} patches" if cfg.n_patches else ""
    print(f"prefill {B} x {S} tokens{prefix} in {prefill_s:.2f}s on "
          f"{device}")
    print(f"decoded {steps} steps x batch {B} in {decode_s:.2f}s "
          f"({steps * B / max(decode_s, 1e-9):.1f} tok/s, store "
          f"v{store.version})")
    print("sample token ids:", toks[0, :16].tolist())
    return {"tokens": toks.cpu(), "params": store._params,
            "version": store.version, "prefill_s": prefill_s,
            "decode_s": decode_s}


if __name__ == "__main__":
    main()
