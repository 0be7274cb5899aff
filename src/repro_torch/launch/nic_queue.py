"""Trace the foMPI-A DHT runs of Fig. 6 event by event and show what
sets their makespan: the victim NIC's atomic queue.

    PYTHONPATH=src python src/repro_torch/launch/nic_queue.py \
        [--P 16] [--seed 0] [--device cpu]

Every foMPI-A access (A_OP, A_OVERFLOW, A_CHAIN) occupies the NIC proxy
word `table[0]` for the cost model's occupancy; A_DONE does not. For
each writer fraction of `bench.dht.bench_dht` this prints the run's
events, its NIC-serialized ops, its makespan and its last three events
(process, pc, start time), then how many events differ between each
pair of writer fractions. Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench import dht
from repro_torch.core import engine
from repro_torch.core.programs.dht import A_DONE

FWS = (0.0, 0.02, 0.05, 0.20)


def trace(P: int, fw: float, seed: int, device) -> tuple:
    """((process, pc, start) per event, makespan) of one foMPI-A run."""
    machine, layout, prog, masks = dht.fompi_a_setup(P, (fw,))
    env = engine.make_env(machine, layout, is_writer=masks[0], target_acq=4,
                          device=device)
    built = prog.build(env)
    st = engine.init_state(env, layout, prog.init_pc(env), prog.n_regs,
                           prog.init_regs(env))
    consts = engine._consts(env, 1)
    stream = engine._KeyStream(env, torch.tensor([seed]), built.draws)
    log = []
    with torch.inference_mode():
        while bool(engine.pending(st, dht.MAX_EVENTS).any()):
            draws = stream.chunk(engine.CHECK_EVERY)
            for j in range(engine.CHECK_EVERY):
                if not bool(engine.pending(st, dht.MAX_EVENTS).any()):
                    break
                t = torch.where(st.done, engine.INF, st.t_ready)[0]
                p = int(t.argmin())
                log.append((p, int(st.pc[0, p]), round(float(t[p]), 4)))
                st = engine._step(built, st,
                                  {k: v[:, j] for k, v in draws.items()},
                                  dht.MAX_EVENTS, consts, False)
    return log, float(st.t_finish[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)
    logs = {}
    for fw in FWS:
        log, makespan = logs[fw] = trace(args.P, fw, args.seed, device)
        nic = sum(pc != A_DONE for _, pc, _ in log)
        print(f"P={args.P} F_W={fw}: {len(log)} events, {nic} NIC ops, "
              f"makespan {makespan!r} us, last events {log[-3:]}")
    for i, a in enumerate(FWS):
        for b in FWS[i + 1:]:
            la, lb = logs[a][0], logs[b][0]
            diff = sum(x[:2] != y[:2] for x, y in zip(la, lb))
            print(f"F_W {a} vs {b}: {diff} of the first "
                  f"{min(len(la), len(lb))} events differ in (process, pc)")


if __name__ == "__main__":
    main()
