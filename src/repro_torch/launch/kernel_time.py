"""Time one of the port's kernels on the card at its main path's layer
shapes, with random inputs made by numpy from seed 0:

- `ssd_scan`: Mamba2-130M's (x [4,1024,24,64] f32, dt [4,1024,24], A
  [24], B/C [4,1024,128], chunk 128);
- `flash_attention_fma`: Qwen2-0.5B's f32 layer (q [4,1024,14,64], k/v
  [4,1024,2,64], causal), the CUDA-core variant;
- `flash_attention_wgmma`: Qwen2-0.5B's bf16 layer (the f32 one's
  shapes), the tensor-core variant at dh 64;
- `flash_attention_wgmma192`: DeepSeek-V3's MLA prefill layer (q/k/v
  [4,1024,128,192] bf16, causal, V's last 64 columns zero as
  `models/mla.py` pads them), on whichever variant the tree's
  `variant()` names (the parent of the tensor-core dh-192 kernel ran it
  on the CUDA cores).

    python src/repro_torch/launch/kernel_time.py \
        [--kernel {ssd_scan,flash_attention_fma,flash_attention_wgmma,
                   flash_attention_wgmma192}]
        [--src TREE/src]

`--src` names the source tree whose `repro_torch` is timed (default:
the one holding this file), so that two checkouts can be compared on
one card in one session, in turns (parent, change, change, parent);
each builds its kernels into its own `build/`. Prints one JSON line:
ms per call (the median over 9 groups of 20 back-to-back calls, each
group between one pair of CUDA events, after a warm-up call), every
group's ms, each CUDA kernel's device ms per call (torch.profiler over
10 calls), the card's name and, for attention, the variant that ran
and its max |kernel - plain version| (so that a design variant timed
here is also held to its plain version).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

# attention kernel -> (q shape, k/v shape, bf16?, V's zero columns from,
# the variant it must take or None for whichever the tree's variant()
# names)
ATTENTION = {
    "flash_attention_fma": ((4, 1024, 14, 64), (4, 1024, 2, 64), False,
                            None, "fma"),
    "flash_attention_wgmma": ((4, 1024, 14, 64), (4, 1024, 2, 64), True,
                              None, "wgmma"),
    "flash_attention_wgmma192": ((4, 1024, 128, 192), (4, 1024, 128, 192),
                                 True, 128, None),
}
KERNELS = ("ssd_scan", *ATTENTION)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=KERNELS, default="ssd_scan",
                    help="the kernel to time")
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[2]),
                    help="the source tree (its src/ directory) to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("kernel_time: no CUDA device")

    rng = np.random.default_rng(0)
    kind = None

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    if args.kernel == "ssd_scan":
        from repro_torch.kernels.ssd_scan import ssd_scan
        b, S, H, P, N = 4, 1024, 24, 64, 128
        dt = torch.nn.functional.softplus(t(b, S, H) - 2.0)
        A = -torch.exp(0.5 * t(H))
        args_ = (t(b, S, H, P), dt, A, t(b, S, N), t(b, S, N))

        def run():
            return ssd_scan(*args_, chunk=128)
    else:
        from repro_torch.kernels import flash_attention as fa
        qs, kvs, bf16, v_zero, want = ATTENTION[args.kernel]
        q, k, v = t(*qs), t(*kvs), t(*kvs)
        if v_zero is not None:
            v[..., v_zero:] = 0
        if bf16:
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        kind = fa.variant(q, k)
        if want not in (None, kind):
            raise SystemExit(f"kernel_time: {args.kernel}'s inputs take the "
                             f"{kind} attention variant, not {want}")

        def run():
            return fa.flash_attention(q, k, v, causal=True)

    out = run()
    err = None
    if kind is not None:
        err = float((out.float() - fa.flash_attention_plain(
            q, k, v, causal=True).float()).abs().max())
    del out
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            # "void (anonymous namespace)::ssd_cb<true>(float const*, ...)"
            name = re.search(r"(\w+(?:<[^>(]*>)?)\(", ev.key)
            passes[name.group(1) if name else ev.key] = (
                ev.self_device_time_total / 10 / 1e3)
    print(json.dumps({"kernel": args.kernel, "src": args.src,
                      "ms": float(np.median(times)), "groups_ms": times,
                      "passes_ms": passes, "variant": kind,
                      "max_abs_err_vs_plain": err,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
