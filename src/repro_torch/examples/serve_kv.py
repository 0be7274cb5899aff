"""Serving example: batched decode with the versioned parameter store
(the paper's DC transplant) and the DHT as the request-metadata store
-- the KV-store usage the paper targets (§5.3).

Requests arrive as (request_id, prompt token); decode steps run against
a shared cache, the BatchedDHT maps request_id -> slot so results can
be claimed out of order, and a background weight swap exercises the
reader/writer protocol.

    PYTHONPATH=src python -m repro_torch.examples.serve_kv [--device cpu]

Counterpart of `examples/serve_kv.py`, on CUDA unless `--device cpu`
(the decode step is plain PyTorch; the DHT runs the dht_probe kernels
on the card).
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.dht import BatchedDHT
from repro_torch.examples._cli import Out, device_arg
from repro_torch.models import lm
from repro_torch.serve import VersionedStore, build_decode_step

ARCH = "qwen2-0.5b"
BATCH = 8
DECODE_STEPS = 24
SWAP_AT = 12


def main(device=None) -> dict:
    """Serves the batch; returns the tokens, the claimed slots, the
    store's version and the printed lines."""
    say = Out()
    device = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    store = VersionedStore(params, n_workers=BATCH, T_DC=4)
    decode = build_decode_step(cfg)

    # Request-metadata DHT: request_id -> batch slot.
    dht = BatchedDHT(nb=4, TB=64, heap=256, device=device)
    meta = dht.init()
    req_ids = torch.as_tensor(np.random.RandomState(0)
                              .permutation(10_000)[:BATCH] + 1,
                              dtype=torch.int32, device=device)
    meta, _ = dht.insert(meta, req_ids,
                         torch.arange(BATCH, dtype=torch.int32,
                                      device=device))

    cache = lm.make_cache(cfg, BATCH, DECODE_STEPS + 4, device=device)
    tok = torch.as_tensor(np.random.RandomState(1)
                          .randint(0, cfg.vocab, (BATCH, 1)),
                          dtype=torch.int32, device=device)

    generated = []
    swapper = None
    for step in range(DECODE_STEPS):
        if step == SWAP_AT:
            # Weight swap from a background thread while readers decode.
            new_params = copy.deepcopy(store._params)
            swapper = threading.Thread(target=store.swap,
                                       args=(new_params,))
            swapper.start()
        with store.reader_view(step % BATCH) as (p, ver):
            tok, cache = decode(p, tok, cache)
        generated.append(tok)
    if swapper:
        swapper.join()

    out = torch.cat(generated, dim=1)
    # Claim results via the metadata DHT.
    slots, found = dht.lookup(meta, req_ids)
    assert bool(found.all())
    for i in range(min(4, BATCH)):
        rid, slot = int(req_ids[i]), int(slots[i])
        say(f"request {rid:5d} (slot {slot}): "
            f"tokens {out[slot, :8].tolist()}")
    say(f"served {BATCH} requests x {DECODE_STEPS} tokens; "
        f"store version now v{store.version} (swapped mid-stream)")
    return {"tokens": out, "req_ids": req_ids, "slots": slots,
            "found": found, "version": store.version, "vocab": cfg.vocab,
            "lines": say.lines}


if __name__ == "__main__":
    main(device_arg(__doc__))
