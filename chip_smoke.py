"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, each fails the run if it fails:

  1. Card: name and power limit (nvidia-smi), then build every CUDA
     kernel from `src/repro_torch/kernels/csrc` (one nvcc per source, all
     started together).
  2. DHT volume (paper §5.3) at a deployment size: nb=16384 blocks x
     TB=1024 slots (16.8 M slots, 128 MiB of keys + values), a 2**22
     entry overflow heap; insert 2**22 distinct keys, then 2**21 of them
     again (updates) plus 2**21 new keys, then look up every present key
     and 2**22 absent ones, all through `BatchedDHT`. Checks the
     volume's invariants, that both kernels ran on this path, and that
     each kernel equals its plain PyTorch version exactly on the inputs
     this path gave it; times both against their bytes-over-bandwidth
     bound.
  3. Lock simulator at the README's and the paper's sizes through
     `Session.run` / `Session.run_batch`: zero violations, completed,
     batch lanes bitwise equal to single runs, and seed-0 events /
     acquires / makespan bits equal to the constants below (derived from
     the JAX reference by tests/test_torch_smoke_constants.py). One
     configuration crashes a writer, so the full handler table (lease
     guards and recovery instructions) runs beside the crash-free one;
     each prints its torch ops per event step.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is the card's name and power limit, and the line before that the
kernels' JSON record. Without a CUDA device, or without the repository
around it, the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet

# ------------------------------------------------------------ simulator
# Each configuration: LockSpec keywords (or a paper_default call), the
# Session workload, and the seeds run as a batch. "jitter": 0.0 sets the
# cost model's jitter (the deterministic P=16 gates).
QUICKSTART_RW = dict(kind="rma_rw", P=64, fanout=(4,), T_DC=16,
                     T_L=(1 << 20, 8), T_R=1024, writer_fraction=0.02)
SIM_CONFIGS = {
    "quickstart_rma_rw": dict(spec=QUICKSTART_RW,
                              session=dict(target_acq=8, cs_kind=1),
                              batch=32),
    "quickstart_fompi_rw": dict(spec=dict(kind="fompi_rw", P=64,
                                          writer_fraction=0.02),
                                session=dict(target_acq=8, cs_kind=1)),
    "paper_rma_rw_256": dict(paper_default=("rma_rw", 256,
                                            dict(writer_fraction=0.02)),
                             session=dict(target_acq=4, cs_kind=0),
                             batch=64),
    "gate_fompi_spin": dict(spec=dict(kind="fompi_spin", P=16, jitter=0.0),
                            session=dict(target_acq=4)),
    "gate_fompi_rw": dict(spec=dict(kind="fompi_rw", P=16,
                                    writer_fraction=0.25, jitter=0.0),
                          session=dict(target_acq=4)),
    "gate_rma_rw": dict(spec=dict(kind="rma_rw", P=16, fanout=(2,), T_DC=4,
                                  T_L=(64, 4), T_R=8, writer_fraction=0.25,
                                  jitter=0.0),
                        session=dict(target_acq=4)),
    "gate_rma_mcs": dict(spec=dict(kind="rma_mcs", P=16, fanout=(4,),
                                   T_L=(64, 4), jitter=0.0),
                         session=dict(target_acq=4)),
    "gate_d_mcs": dict(spec=dict(kind="d_mcs", P=16, jitter=0.0),
                       session=dict(target_acq=4)),
}
# The rma_rw gate with writer 3 crashing at 1.5 us (the README's crash
# example): runs the full handler table, recovery instructions included.
SIM_CONFIGS["crash_rma_rw"] = dict(SIM_CONFIGS["gate_rma_rw"],
                                   fault=(3, 1.5))
# Seed-0 (events, total_acquires, makespan as float32 bits) of the JAX
# reference for each configuration.
SIM_EXPECTED = {
    "quickstart_rma_rw": (3478, 512, 1138838875),
    "quickstart_fompi_rw": (5073, 512, 1149558392),
    "paper_rma_rw_256": (6190, 1024, 1133293391),
    "gate_fompi_spin": (744, 64, 1131936403),
    "gate_fompi_rw": (1101, 64, 1130390740),
    "gate_rma_rw": (648, 64, 1126613649),
    "gate_rma_mcs": (951, 64, 1116327758),
    "gate_d_mcs": (831, 64, 1109342288),
    "crash_rma_rw": (655, 60, 1128920194),
}


def make_spec(LockSpec, CostModel, cfg: dict):
    """The configuration's LockSpec, built with the given package's
    classes (the port's here; the JAX reference's in the CPU test)."""
    if "paper_default" in cfg:
        kind, P, kw = cfg["paper_default"]
        return LockSpec.paper_default(kind, P, **kw)
    kw = dict(cfg["spec"])
    if "jitter" in kw:
        kw["cost"] = CostModel(jitter=kw.pop("jitter"))
    return LockSpec(**kw)


def run_seed(sess, engine, cfg: dict, seed: int):
    """Seed `seed` of a configuration on its session: `Session.run`, or
    `engine.run_sim` under the configuration's crash plan (either
    package's session and engine)."""
    if "fault" not in cfg:
        return sess.run(seed)
    plan = engine.FaultPlan.single(sess.spec.P, *cfg["fault"])
    return engine.run_sim(sess.program, sess.env, sess.layout, seed=seed,
                          max_events=sess.max_events, fault=plan)


# ------------------------------------------------------------------ DHT
DHT_NB, DHT_TB, DHT_HEAP, DHT_K = 16384, 1024, 1 << 22, 1 << 22


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, n: int, groups: int = 5) -> float:
    """fn's time per call on the card: the median over `groups` groups
    of n back-to-back calls, each group between one pair of CUDA events,
    after one warm-up call. The host queues each launch while the card
    runs the one before, so its own cost per call stays hidden."""
    import numpy as np
    import torch
    fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def dht_phase(seed: int) -> list:
    import numpy as np
    import torch

    from repro_torch.dht import BatchedDHT
    from repro_torch.kernels import dht_probe, ops

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    K, half = DHT_K, DHT_K // 2
    # 2**22 batch-1 keys, 2**21 new batch-2 keys, 2**22 absent keys.
    need = 2 * K + half
    pool = np.unique(rng.randint(1, 2**31 - 1, size=need + need // 8,
                                 dtype=np.int64))
    check(len(pool) >= need, "not enough distinct keys drawn")
    pool = rng.permutation(pool)[:need].astype(np.int32)
    keys1, new2, absent = pool[:K], pool[K:K + half], pool[K + half:]
    vals1 = rng.randint(0, 1 << 30, size=K).astype(np.int32)
    upd = rng.permutation(K)[:half]                 # batch-1 keys re-inserted
    keys2 = np.concatenate([keys1[upd], new2])
    perm2 = rng.permutation(K)
    keys2 = keys2[perm2]
    vals2 = ((1 << 30) + rng.randint(0, 1 << 30, size=K)).astype(np.int32)
    # Latest value of every present key: batch 2's where re-inserted.
    at2 = np.argsort(perm2)            # position in keys2 of each source row
    latest1 = vals1.copy()
    latest1[upd] = vals2[at2[:half]]
    latest_new = vals2[at2[half:]]

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k1, v1, k2, v2 = gpu(keys1), gpu(vals1), gpu(keys2), gpu(vals2)
    present = np.concatenate([keys1, new2])
    lookups = [gpu(keys1), gpu(new2), gpu(absent)]   # <= 2**22 per call

    dht = BatchedDHT(nb=DHT_NB, TB=DHT_TB, heap=DHT_HEAP)
    st0 = dht.init()
    # ---- main path, counted ----
    dht_probe.dht_insert.launches = 0
    dht_probe.dht_lookup.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1, s1 = dht.insert(st0, k1, v1)
    st2, s2 = dht.insert(st1, k2, v2)
    results = [dht.lookup(st2, q) for q in lookups]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dht_insert": dht_probe.dht_insert.launches,
                "dht_lookup": dht_probe.dht_lookup.launches}
    print(f"dht main path: 2 inserts + 3 lookups of <= {K} keys in "
          f"{wall:.4f} s, launches {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the DHT path never launched: {launches}")

    # ---- invariants ----
    for name, st_prev, st_next, status in (("batch 1", st0, st1, s1),
                                           ("batch 2", st1, st2, s2)):
        counts = torch.bincount(status.long(), minlength=3).tolist()
        check(len(counts) == 3 and sum(counts) == K,
              f"{name}: statuses {counts} do not cover the batch")
        grow = int(st_next.heap_ptr) - int(st_prev.heap_ptr)
        check(grow == counts[2], f"{name}: heap grew {grow}, overflow "
              f"{counts[2]}")
        print(f"dht {name}: insert {counts[0]}, update {counts[1]}, "
              f"overflow {counts[2]}, heap_ptr {int(st_next.heap_ptr)}",
              flush=True)
    check(int(st2.heap_ptr) <= DHT_HEAP, "heap overflowed its capacity")
    for expect, (vals, found) in zip((latest1, latest_new), results[:2]):
        check(bool(found.all()), "an inserted key was not found")
        check(np.array_equal(vals.cpu().numpy(), expect),
              "a present key did not return its latest value")
    vals, found = results[2]
    check(not bool(found.any()) and bool((vals == -1).all()),
          "an absent key was found")
    print(f"dht invariants: {len(present)} present keys found with their "
          f"latest values, {len(absent)} absent keys not found", flush=True)

    # ---- each kernel against its plain version, on this path's inputs
    nb, TB = DHT_NB, DHT_TB
    KB = ops.bucket_capacity(K)
    kr, vr, _ = ops.route_keys(k2, v2, nb, TB, KB)        # batch 2
    tk, tv = st1.table_keys, st1.table_vals
    got = dht_probe.dht_insert(tk, tv, kr, vr)
    want = dht_probe.dht_insert_plain(tk, tv, kr, vr)
    ins_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
    tk2, tv2 = st2.table_keys, st2.table_vals
    look_err = 0
    for q in (lookups[2], lookups[0]):        # absent keys, then batch 1
        qr, _, _ = ops.route_keys(q, q, nb, TB, KB)
        lgot = dht_probe.dht_lookup(tk2, tv2, qr)
        lwant = dht_probe.dht_lookup_plain(tk2, tv2, qr)
        look_err = max([look_err] + [int((a.long() - b.long()).abs().max())
                                     for a, b in zip(lgot, lwant)])
    torch.cuda.synchronize()
    check(ins_err == 0, f"dht_insert differs from its plain version by "
          f"{ins_err}")
    check(look_err == 0, f"dht_lookup differs from its plain version by "
          f"{look_err}")

    # ---- timing and bounds (bytes each function must move) ----
    lanes = nb * KB
    ins_bytes = 4 * (4 * nb * TB + 3 * lanes)   # tk,tv in+out; keys,vals,status
    valid = int((qr != -1).sum())
    hits = int(lgot[1].sum())
    look_bytes = 4 * lanes + 4 * valid + 4 * hits + 5 * lanes
    rows = []
    for name, line, ms, plain_ms, nbytes, err in (
            ("dht_insert", 40,
             cuda_ms(lambda: dht_probe.dht_insert(tk, tv, kr, vr), 20),
             cuda_ms(lambda: dht_probe.dht_insert_plain(tk, tv, kr, vr), 5),
             ins_bytes, ins_err),
            ("dht_lookup", 84,
             cuda_ms(lambda: dht_probe.dht_lookup(tk2, tv2, qr), 20),
             cuda_ms(lambda: dht_probe.dht_lookup_plain(tk2, tv2, qr), 5),
             look_bytes, look_err)):
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dht_probe.cu",
            "replaces": f"src/repro/kernels/dht_probe.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None})
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms), bound "
              f"{bound_ms:.4f} ms for {nbytes} bytes, "
              f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
    return rows


def ops_per_step(run, device_type: str = "cuda"):
    """Torch ops dispatched per event step of `run(steps)` (seed 0 cut
    at `steps` events), in all and with a tensor on the card: the
    difference between a 128- and a 64-step run over 64, so set-up and
    summary cancel. The engine is launch-bound, so this is its cost
    model."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.all = self.device = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.all += 1
            self.device += any(isinstance(t, torch.Tensor)
                               and t.device.type == device_type
                               for t in tree_leaves((args, kwargs)))
            return func(*args, **(kwargs or {}))

    counts = []
    for steps in (64, 128):
        with Count() as c:
            run(steps)
        counts.append((c.all, c.device))
    return tuple((b - a) / 64 for a, b in zip(*counts))


def key_chain(env, lanes: int, steps_per_s: float):
    """Print the host's time per event step for the engine's threefry
    key chain (`engine._KeyStream`, the draws' copy to the card
    included) at `lanes` lanes, and its share of a step at the rate a
    run just measured."""
    import torch

    from repro_torch.core import engine
    stream = engine._KeyStream(env, torch.arange(lanes))
    chunks = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        stream.chunk(engine.CHECK_EVERY)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / (chunks * engine.CHECK_EVERY)
    print(f"  host key chain, {lanes} lanes: {1e3 * per_step:.4f} ms per "
          f"event step, {100 * per_step * steps_per_s:.1f}% of a step at "
          f"{steps_per_s:.1f} steps/s", flush=True)


def sim_phase():
    import numpy as np
    import torch

    from repro_torch.core import LockSpec, Session, engine, metrics_at
    from repro_torch.core.cost import CostModel

    def bits(x):
        return int(np.asarray(x.cpu(), np.float32).view(np.uint32))

    def same(a, b) -> bool:
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, cfg in SIM_CONFIGS.items():
        spec = make_spec(LockSpec, CostModel, cfg)
        sess = Session(spec, **cfg["session"])
        cut = {steps: Session(spec, max_events=steps, **cfg["session"])
               for steps in (64, 128)}
        n_all, n_dev = ops_per_step(
            lambda steps: run_seed(cut[steps], engine, cfg, 0))
        table = "full" if "fault" in cfg else "crash-free"
        print(f"sim {name}: {n_all:.1f} torch ops per event step, "
              f"{n_dev:.1f} of them on the card ({table} handler table)",
              flush=True)
        singles = {}
        for seed in ((0, 1) if cfg.get("batch") else (0,)):
            m, dt = timed(lambda: run_seed(sess, engine, cfg, seed))
            singles[seed] = m
            ev = int(m.events)
            print(f"sim {name} run({seed}): events {ev}, acquires "
                  f"{int(m.total_acquires)}, makespan {float(m.makespan)} us, "
                  f"violations {int(m.violations)}, crashed "
                  f"{int(m.n_crashed)}, reclaims {int(m.reclaims)}, "
                  f"{dt:.2f} s, {ev / dt:.1f} event steps/s", flush=True)
            check(int(m.violations) == 0 and bool(m.completed),
                  f"{name} run({seed}): violations or not completed")
            if "fault" in cfg:
                check(int(m.n_crashed) == 1 and int(m.reclaims) >= 1,
                      f"{name} run({seed}): the crash was not recovered")
            if seed == 0 and spec.cost.jitter > 0.0:
                key_chain(sess.env, 1, ev / dt)
        m0 = singles[0]
        got = (int(m0.events), int(m0.total_acquires), bits(m0.makespan))
        check(got == SIM_EXPECTED[name],
              f"{name}: seed 0 gave {got}, reference {SIM_EXPECTED[name]}")
        n = cfg.get("batch")
        if n:
            mb, dt = timed(lambda: sess.run_batch(range(n)))
            steps = int(mb.events.max())
            print(f"sim {name} run_batch({n}): events {int(mb.events.min())}"
                  f"..{steps}, {dt:.2f} s, {steps / dt:.1f} event steps/s, "
                  f"{int(mb.events.sum()) / dt:.1f} lane-events/s",
                  flush=True)
            if spec.cost.jitter > 0.0:
                key_chain(sess.env, n, steps / dt)
            check(int(mb.violations.sum()) == 0 and bool(mb.completed.all()),
                  f"{name} batch: violations or not completed")
            for s in (0, 1):
                check(same(metrics_at(mb, s), singles[s]),
                      f"{name}: batch lane {s} differs from run({s})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the DHT phase's keys and values")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    logs, secs = build.timed_build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in {secs:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu ptxas: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    kernels = dht_phase(args.seed)
    print(f"dht phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sim_phase()
    print(f"simulator phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
