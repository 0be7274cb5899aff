"""locklint: protocol static analyzer + small-P model checker CLI, on
the port's engine (counterpart of `repro.analysis.locklint`).

Checks every registered lock kind (plus the lock-free DHT program) at
exhaustively-explorable sizes:

  * layout pass — `lints.check_layout` over a (fanout, T_DC, padding)
    lattice of window layouts; numpy-only, no simulation.
  * bounds/structure/wakeup passes — per configuration, the model
    explorer samples reachable states, `ir.extract` replays every
    reached instruction through the footprint recorder, and the lints
    check the result against the program's declared ProgramMeta.
  * model pass — exhaustive BFS over all interleavings at P=2..3:
    mutual exclusion, reader/writer exclusion, deadlock/livelock
    freedom, and terminal completeness (repro_torch.analysis.model),
    one engine call per breadth-first level.

Run as (on CUDA unless `--device` says otherwise):

    python -m repro_torch.analysis.locklint --all
    python -m repro_torch.analysis.locklint --kind rma_rw -v
    python -m repro_torch.analysis.locklint --all --quick   # CI subset
    python -m repro_torch.analysis.locklint --all --device cpu

Exit status is non-zero iff any finding survives. The per-config
interleaving counts printed by --all back the paper's §4.4 claim of
model-checked correctness with an actually-enumerated state space. The
table is the reference's; after it, one line per config gives the wall
time, the breadth-first levels and the widest level's lanes.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch.core import engine
from repro_torch.core.spec import LockSpec, writer_mask
from repro_torch.core.window import build_layout
from repro_torch.analysis import ir, lints
from repro_torch.analysis.model import Explorer


@dataclasses.dataclass(frozen=True)
class Config:
    """One exhaustively-checked configuration of a lock kind."""

    kind: str
    P: int
    fanout: tuple = ()
    T_DC: int = 1
    T_L: tuple | None = None
    T_R: int = 1 << 26
    writer_fraction: float | None = None
    target_acq: int = 2
    quick: bool = True            # include in the --quick CI subset
    model_seeds: tuple = (0,)
    crash_victim: int | None = None   # crash-fault model: kill this proc

    @property
    def label(self) -> str:
        parts = [f"P={self.P}"]
        if self.fanout:
            parts.append(f"fanout={self.fanout}")
        if self.T_L is not None:
            parts.append(f"T_DC={self.T_DC}", )
            parts.append(f"T_L={self.T_L}")
            parts.append(f"T_R={self.T_R}")
        if self.writer_fraction is not None:
            parts.append(f"wf={self.writer_fraction}")
        parts.append(f"acq={self.target_acq}")
        if self.crash_victim is not None:
            parts.append(f"crash=p{self.crash_victim}")
        return " ".join(parts)

    def spec(self) -> LockSpec:
        kw = {}
        if self.T_L is not None:
            kw.update(T_DC=self.T_DC, T_L=self.T_L, T_R=self.T_R)
        if self.writer_fraction is not None:
            kw.update(writer_fraction=self.writer_fraction)
        return LockSpec(kind=self.kind, P=self.P, fanout=self.fanout,
                        **kw)


# Configurations are chosen so the UNION of reached pcs per kind covers
# every live instruction: writer-only contention exercises the queue
# links and root waits, mixed roles exercise the counters and the
# reader barrier paths, and fanout=(1,) vs (2,) moves the contention
# between the leaf and root queues. crash_victim configs additionally
# explore every interleaving with one process crashing at any point
# (model.Explorer's crash transition), proving the lease-recovery
# paths keep mutual exclusion and let every survivor complete; they
# also provide the recovery pcs' coverage.
CONFIGS = {
    "rma_rw": (
        # Mixed writer/reader with a tiny reader batch: counters, the
        # reader barrier/check-tail/reset paths, and the SCTW verify.
        Config("rma_rw", P=2, fanout=(2,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=0.5, target_acq=2),
        # Writer-writer contention in one leaf: queue links, local
        # passes, the late-successor unwind, and the MODE_CHANGE path.
        Config("rma_rw", P=2, fanout=(1,), T_DC=1, T_L=(1, 2), T_R=1,
               writer_fraction=1.0, target_acq=2, quick=False),
        # Two writers in DIFFERENT leaves: root-queue contention, i.e.
        # the ROOT_WAITSUCC/ROOT_PASS handoff between distinct entities.
        Config("rma_rw", P=2, fanout=(2,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=1.0, target_acq=2, quick=False),
        Config("rma_rw", P=3, fanout=(3,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=0.34, target_acq=1, quick=False),
        # Writer (p0) crashes: the reader recovers via R_UNBAR.
        Config("rma_rw", P=2, fanout=(2,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=0.5, target_acq=2, crash_victim=0),
        # Reader (p1) crashes: the writer drains via REC_DRAIN.
        Config("rma_rw", P=2, fanout=(2,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=0.5, target_acq=2, crash_victim=1,
               quick=False),
        # Writer-writer crash: queue inheritance inside the RW program.
        Config("rma_rw", P=2, fanout=(1,), T_DC=1, T_L=(1, 2), T_R=1,
               writer_fraction=1.0, target_acq=2, crash_victim=0,
               quick=False),
        Config("rma_rw", P=2, fanout=(2,), T_DC=1, T_L=(1, 1), T_R=1,
               writer_fraction=1.0, target_acq=2, crash_victim=0,
               quick=False),
    ),
    "rma_mcs": (
        # Leaf contention: both procs in one element's queue.
        Config("rma_mcs", P=2, fanout=(1,), T_L=(1, 2), target_acq=2),
        # Root contention: one proc per element.
        Config("rma_mcs", P=2, fanout=(2,), T_L=(2, 1), target_acq=2,
               quick=False),
        Config("rma_mcs", P=3, fanout=(3,), T_L=(1, 1), target_acq=1,
               quick=False),
        Config("rma_mcs", P=2, fanout=(1,), T_L=(1, 2), target_acq=2,
               crash_victim=0),
        Config("rma_mcs", P=2, fanout=(2,), T_L=(2, 1), target_acq=2,
               crash_victim=0, quick=False),
        Config("rma_mcs", P=3, fanout=(3,), T_L=(1, 1), target_acq=1,
               crash_victim=0, quick=False),
    ),
    "d_mcs": (
        Config("d_mcs", P=2, target_acq=2),
        Config("d_mcs", P=3, target_acq=1, quick=False),
        Config("d_mcs", P=2, target_acq=2, crash_victim=0),
        Config("d_mcs", P=3, target_acq=1, crash_victim=0,
               quick=False),
    ),
    "fompi_spin": (
        Config("fompi_spin", P=2, target_acq=2),
        Config("fompi_spin", P=3, target_acq=2, quick=False),
        Config("fompi_spin", P=2, target_acq=2, crash_victim=0),
    ),
    "fompi_rw": (
        Config("fompi_rw", P=2, writer_fraction=0.5, target_acq=2),
        Config("fompi_rw", P=3, writer_fraction=0.34, target_acq=2,
               quick=False),
        # Writer (p0) crashes: readers recover via R_REC.
        Config("fompi_rw", P=2, writer_fraction=0.5, target_acq=2,
               crash_victim=0),
        # Reader (p1) crashes: the writer recovers via W_DRAIN.
        Config("fompi_rw", P=2, writer_fraction=0.5, target_acq=2,
               crash_victim=1, quick=False),
        # Writer (p0) crashes with a surviving writer (p2): W_REC.
        Config("fompi_rw", P=3, writer_fraction=0.67, target_acq=1,
               crash_victim=0, quick=False),
    ),
}


@dataclasses.dataclass
class ConfigStats:
    kind: str
    config: str
    n_states: int = 0
    n_edges: int = 0
    n_interleavings: int = 0
    interleavings_capped: bool = False
    capped: bool = False
    seconds: float = 0.0      # wall time of every pass of the config
    levels: int = 0           # breadth-first levels, over model seeds
    widest: int = 0           # lanes of the widest level's engine call


def check_config(program, env, layout, meta, config_label, *,
                 max_states=150_000, model_seeds=(0,), verbose=False,
                 crash_victim=None):
    """All dynamic passes for one built configuration.

    Returns (findings, stats, union_reached) where union_reached also
    counts replay-observed successor pcs (branches the fixed model key
    never takes, e.g. the DHT's randomized overflow path).
    """
    findings = []
    stats = ConfigStats(meta.name, config_label)
    union_reached = set()
    t0 = time.perf_counter()
    for seed in model_seeds:
        ex = Explorer(program, env, layout, max_states=max_states,
                      model_seed=seed, crash_victim=crash_victim)
        res = ex.explore()
        stats.n_states += res.n_states
        stats.n_edges += res.n_edges
        stats.n_interleavings = max(stats.n_interleavings,
                                    res.n_interleavings)
        stats.interleavings_capped |= res.interleavings_capped
        stats.capped |= res.capped
        stats.levels += res.levels
        stats.widest = max(stats.widest, res.widest)
        for mf in res.findings:
            findings.append(lints.Finding(
                "model", meta.name,
                f"{mf.kind}: {mf.message}; trace: "
                f"{mf.render_trace(meta)}", config=config_label))
        pir = ir.extract(program, env, layout, res, meta=meta)
        union_reached |= pir.pc_reached
        for pcir in pir.instrs.values():
            union_reached |= set(pcir.successors)
        findings += lints.check_bounds(pir, layout, meta, config_label)
        findings += lints.check_structure(pir, meta, config_label)
        findings += lints.check_wakeup(pir, meta, layout, config_label)
        findings += lints.check_recovery(
            pir, meta, crashed=crash_victim is not None,
            config=config_label)
        if verbose:
            print(f"    seed {seed}: {res.n_states} states, "
                  f"{res.n_edges} edges, "
                  f"{res.n_interleavings}{'+' if res.interleavings_capped else ''} "
                  f"interleavings, {len(res.findings)} model findings")
    stats.seconds = time.perf_counter() - t0
    return findings, stats, union_reached


def check_kind(kind: str, *, quick=False, max_states=150_000,
               verbose=False, device=None):
    """Run every pass over every configuration of one registered kind
    (on CUDA unless `device` says otherwise)."""
    findings, all_stats = [], []
    union_reached = set()
    meta = None
    configs = [c for c in CONFIGS[kind] if c.quick or not quick]
    for cfg in configs:
        spec = cfg.spec()
        from repro_torch.core.session import Session
        s = Session(spec, target_acq=cfg.target_acq, cs_kind=0,
                    think=False, device=device)
        meta = s.program.meta(s.env)
        if verbose:
            print(f"  {cfg.label}")
        f, st, reached = check_config(
            s.program, s.env, s.layout, meta, cfg.label,
            max_states=max_states, model_seeds=cfg.model_seeds,
            verbose=verbose, crash_victim=cfg.crash_victim)
        findings += f
        all_stats.append(st)
        union_reached |= reached
    # Coverage is a union property over the FULL config set; the quick
    # subset (one config per kind) deliberately leaves paths like the
    # root-queue handoff to its sibling configs, so only the full run
    # may assert it.
    if meta is not None and not quick:
        labels = "; ".join(c.label for c in configs)
        findings += lints.check_coverage(meta, union_reached, labels)
    return findings, all_stats


def check_layout_lattice(verbose=False):
    """Layout lints over corner (P, fanout, T_DC, padding) points."""
    from repro_torch.core.topology import build_machine
    findings = []
    lattice = [
        (2, ()), (3, ()), (4, (2,)), (8, (2,)), (8, (4,)),
        (8, (2, 2)), (16, (4,)), (16, (2, 4)), (32, (2, 4)),
    ]
    n = 0
    for P, fanout in lattice:
        m = build_machine(P, fanout)
        for T_DC in sorted({1, 2, P // 2 or 1, P}):
            if not 1 <= T_DC <= P:
                continue
            n_ctr = len(range(0, P, T_DC))
            for extra in (0, 4):
                for pad in (None, P, P + 3):
                    if pad is not None and pad < n_ctr:
                        continue
                    lay = build_layout(m, T_DC=T_DC, extra_words=extra,
                                       pad_counters_to=pad)
                    cfg = (f"P={P} fanout={fanout} T_DC={T_DC} "
                           f"extra={extra} pad={pad}")
                    findings += lints.check_layout(lay, m, cfg)
                    n += 1
    if verbose:
        print(f"  layout lattice: {n} layouts checked")
    return findings


def check_dht(*, max_states=60_000, verbose=False, device=None):
    """The lock-free foMPI-A DHT program (the Fig. 6 benchmark's wiring
    at P=3, 4 table words + heap pointer in scratch; on CUDA unless
    `device` says otherwise)."""
    from repro_torch.core.programs.dht import FompiADHT
    n_table = 4
    spec = LockSpec(kind="fompi_spin", P=3)
    machine = spec.machine()
    layout = spec.layout(machine, extra_words=n_table + 1)
    W = layout.W
    table_words = np.arange(W - n_table - 1, W - 1, dtype=np.int32)
    heap_word = W - 1
    mask = writer_mask(3, 0.34)
    program = FompiADHT(table_words, heap_word, mask)
    env = engine.make_env(machine, layout, is_writer=mask, target_acq=2,
                          device=device)
    meta = program.meta(env)
    label = "P=3 table=4 wf=0.34"
    if verbose:
        print(f"  {label}")
    # Branches (collision/chain) consume the model key, so union
    # coverage needs a few seeds; each exploration stays exhaustive.
    findings, stats, reached = check_config(
        program, env, layout, meta, label, max_states=max_states,
        model_seeds=(0, 1, 2, 3), verbose=verbose)
    findings += lints.check_coverage(meta, reached, label)
    return findings, [stats]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.locklint",
        description="Static analyzer + small-P model checker for the "
                    "lock instruction programs.")
    ap.add_argument("--all", action="store_true",
                    help="check every registered kind, the DHT program "
                         "and the layout lattice")
    ap.add_argument("--kind", action="append", default=[],
                    choices=sorted(CONFIGS) + ["dht", "layout"],
                    help="check one kind (repeatable); 'dht' and "
                         "'layout' select the extra passes")
    ap.add_argument("--quick", action="store_true",
                    help="CI subset: one small config per kind")
    ap.add_argument("--max-states", type=int, default=150_000)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the model checker (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)

    targets = list(args.kind)
    if args.all or not targets:
        targets = sorted(CONFIGS) + ["dht", "layout"]

    findings, stats = [], []
    for t in targets:
        print(f"[locklint] {t}")
        if t == "layout":
            findings += check_layout_lattice(verbose=args.verbose)
        elif t == "dht":
            f, st = check_dht(max_states=args.max_states,
                              verbose=args.verbose, device=device)
            findings += f
            stats += st
        else:
            f, st = check_kind(t, quick=args.quick,
                               max_states=args.max_states,
                               verbose=args.verbose, device=device)
            findings += f
            stats += st

    print()
    for st in stats:
        cap = " (state cap hit; properties cover explored prefix)" \
            if st.capped else ""
        plus = "+" if st.interleavings_capped else ""
        print(f"  {st.kind:<11} {st.config:<44} "
              f"{st.n_states:>7} states {st.n_edges:>8} edges "
              f"{st.n_interleavings}{plus} interleavings{cap}")
    print()
    for st in stats:
        print(f"  {st.kind:<11} {st.config:<44} {st.seconds:8.2f} s "
              f"{st.levels:>5} levels {st.widest:>7} lanes in the widest")
    print(f"  {sum(st.seconds for st in stats):.2f} s in all on {device}")
    print()
    if findings:
        print(f"locklint: {len(findings)} finding(s)")
        for f in findings:
            print(f"  {f}")
        return 1
    print("locklint: clean "
          f"({len(stats)} configs, {sum(s.n_states for s in stats)} "
          "states explored)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
