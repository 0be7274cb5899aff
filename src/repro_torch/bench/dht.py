"""DHT case study -- Fig. 6 of the paper.

P processes hammer one victim volume with F_W inserts / (1-F_W) reads
under three synchronization schemes: foMPI-A (lock-free CAS/FAO),
foMPI-RW (centralized RW lock), RMA-RW (ours). Metric: total simulated
execution time for a fixed op budget.

Each scheme runs its writer fractions as the lanes of ONE run on
`device` (CUDA unless "cpu"): foMPI-A through the env's "roles" lattice
group, the locked kinds through `Session.sweep("writer_fraction", ...)`.
Every row equals a fresh single run bit for bit. Also a wall-clock
benchmark of the batched table (`BatchedDHT`, the CUDA dht_probe
kernels). Counterpart of `benchmarks/dht_bench.py`: same functions plus
`device=`, same rows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.locks import make_session
from repro_torch.core import LockSpec, engine, metrics_at, writer_mask
from repro_torch.core.programs.dht import FompiADHT

N_TABLE_WORDS = 64


MAX_EVENTS = 1_500_000


def _normalized_us(m, P, target_acq):
    """Total-time estimate: us/op x total ops. Exact when the run
    completed; a steady-state estimator when it hit the event cap
    (centralized locks at P>=256 converge extremely slowly -- the
    paper's 'does not scale' behaviour)."""
    done = int(m.total_acquires)
    if done == 0:                 # saturated: no op finished in budget
        return float("inf")
    return float(m.makespan) / done * (P * target_acq)


def fompi_a_setup(P, fws):
    """(machine, layout, program, masks) of the foMPI-A runs at P: the
    lock-free spec's machine and window, with the table words and the
    heap pointer in the extra scratch area (owned round-robin), and one
    writer mask per writer fraction."""
    spec = LockSpec(kind="fompi_spin", P=P)
    machine = spec.machine()
    layout = spec.layout(machine, extra_words=N_TABLE_WORDS + 1)
    W = layout.W
    table_words = np.arange(W - N_TABLE_WORDS - 1, W - 1, dtype=np.int32)
    heap_word = W - 1
    masks = [writer_mask(P, fw) for fw in fws]
    return machine, layout, FompiADHT(table_words, heap_word, masks[0]), masks


def run_fompi_a(P, fws, target_acq, seed=0, device=None) -> engine.Metrics:
    """foMPI-A at every writer fraction in `fws`, one lane each (the
    env's "roles" group, one row per F_W); Metrics with a leading
    [len(fws)] axis."""
    machine, layout, prog, masks = fompi_a_setup(P, fws)
    env = engine.make_env(machine, layout, is_writer=masks,
                          lanes={"roles": np.arange(len(fws))},
                          target_acq=target_acq, device=device)
    return engine.run_sim_batch(prog, env, layout, seeds=[seed] * len(fws),
                                max_events=MAX_EVENTS)


def run_locked(kind, P, fws, target_acq, seed=0, device=None):
    """A lock-protected scheme at every writer fraction in `fws`, as
    lanes of one `Session.sweep`; Metrics with leading [len(fws), 1]."""
    sess = make_session(kind, P, bench="sob", target_acq=target_acq,
                        writer_fraction=fws[0], max_events=MAX_EVENTS,
                        device=device)
    m = sess.sweep("writer_fraction", fws, seeds=(seed,))
    if int(m.violations.sum()) != 0:
        raise RuntimeError(f"{kind} P={P}: mutual exclusion violated")
    return m


def bench_dht(ps=(16, 64), fws=(0.0, 0.02, 0.05, 0.20), target_acq=4,
              device=None):
    out = []
    for P in ps:
        a = run_fompi_a(P, fws, target_acq, device=device)
        locked = {k: run_locked(k, P, fws, target_acq, device=device)
                  for k in ("fompi_rw", "rma_rw")}
        for i, fw in enumerate(fws):
            out.append({
                "bench": "dht", "P": P, "F_W": fw,
                "fompi_a_us": _normalized_us(metrics_at(a, i), P,
                                             target_acq),
                "fompi_rw_us": _normalized_us(
                    metrics_at(locked["fompi_rw"], i, 0), P, target_acq),
                "rma_rw_us": _normalized_us(
                    metrics_at(locked["rma_rw"], i, 0), P, target_acq)})
    return out


def _wall_s(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of fn over `iters` calls after one warm-up: CUDA
    events around the calls on the card, the host's clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_batched_table(n_keys=512, nb=16, TB=256, iters=20, device=None):
    """Wall-clock of the batched table's insert and lookup (the CUDA
    dht_probe kernels on the card, their plain versions on the CPU)."""
    from repro_torch.dht import BatchedDHT

    dht = BatchedDHT(nb=nb, TB=TB, heap=4 * n_keys, device=device)
    rng = np.random.RandomState(0)
    keys = torch.as_tensor(rng.permutation(1 << 20)[:n_keys] + 1,
                           dtype=torch.int32, device=dht.device)
    vals = torch.arange(n_keys, dtype=torch.int32, device=dht.device)
    st, _ = dht.insert(dht.init(), keys, vals)
    insert_s = _wall_s(lambda: dht.insert(dht.init(), keys, vals), iters,
                       dht.device)
    lookup_s = _wall_s(lambda: dht.lookup(st, keys), iters, dht.device)
    return [{"bench": "dht_table", "n_keys": n_keys,
             "insert_us_per_batch": insert_s * 1e6,
             "lookup_us_per_batch": lookup_s * 1e6}]
