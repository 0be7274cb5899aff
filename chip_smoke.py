"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, each fails the run if it fails:

  1. Card: name and power limit (nvidia-smi), then build every CUDA
     kernel from `src/repro_torch/kernels/csrc` (one nvcc per source, all
     started together), print ptxas's registers, shared memory and
     spills (fails if the tensor-core attention kernel spills), and
     count the HGMMA (`wgmma`) instructions in its SASS (cuobjdump;
     fails if none).
  2. DHT volume (paper §5.3) at a deployment size: nb=16384 blocks x
     TB=1024 slots (16.8 M slots, 128 MiB of keys + values), a 2**22
     entry overflow heap; insert 2**22 distinct keys, then 2**21 of them
     again (updates) plus 2**21 new keys, then look up every present key
     and 2**22 absent ones, all through `BatchedDHT`. Checks the
     volume's invariants, that both kernels ran on this path, and that
     each kernel equals its plain PyTorch version exactly on the inputs
     this path gave it; times both against their bytes-over-bandwidth
     bound (the lookup's scattered table reads counted in 32-byte
     sectors, `dht_lookup_bytes`).
  3. Serving (`repro_torch.launch.serve.generate`) of Qwen2-0.5B and
     Mamba2-130M at full width, random weights from a seeded
     torch.Generator on the card, under a VersionedStore(n_workers=4,
     T_DC=1): prefill 4 x 1024 tokens, then 32 greedy tokens with a
     weight swap from a background thread at decode step 16. Checks
     that the prefill ran the flash_attention / ssd_scan kernel once per
     layer (for Qwen2's bf16 prefill, the tensor-core variant: its own
     counter equals n_layers), that teacher-forced decode after a
     1016-token prefill matches a 1024-token prefill's logits (f32 at
     1e-3; bf16 at 0.06), each dtype's run counted too (Qwen2's f32 run
     is the CUDA-core attention variant's path), that logits are finite
     and tokens in [0, vocab), and that the store's version rose by
     exactly 1. Holds each kernel against its plain PyTorch version and
     its oracle in kernels/ref.py on the inputs layer 0 of its path gave
     it (bf16 attention at 2e-2, f32 attention at 2e-5, SSD at 2e-4,
     y and the final state). Times each kernel against its bound and
     its plain version; attention and PyTorch's
     scaled_dot_product_attention by their device time (torch.profiler),
     with CUDA-event times in turns (kernel, SDPA, kernel) beside; counts
     and times (torch.profiler) the CUDA kernels one ssd_scan call
     launches.
     Then every other arch at full width (all layers, published widths,
     f32 masters; the MoE archs keep every expert and cut depth to fit
     one card, FAMILY_ARCHS): StarCoder2-7B, OLMo-1B, H2O-Danube-1.8B,
     InternVL2-2B (behind 256 stub patches), Zamba2-2.7B, DeepSeek-V3
     (one dense MLA layer, one MoE layer) and Arctic (one layer) served
     the same way, HuBERT-XLarge (an encoder) by a 4 x 1024-frame
     prefill. Each checks its parameter count, its prefill's launches
     (flash_attention once per attention application, every one on the
     tensor-core variant, MLA's dh 192 too; Zamba2's ssd_scan once per
     Mamba2 layer), teacher-forced decode against prefill (f32
     gated at 1e-3; the MoE archs on a 1 x 64 prompt at capacity factor
     E / K, so that nothing is dropped; H2O-Danube also at 1 x 8192,
     past its 4096-token window), tokens in range and the swap landed,
     and prints prefill s, decode ms per step, torch ops per step and
     peak memory. The new kernel shapes are held against their plain
     versions and oracles and timed (HuBERT's dh 80 non-causal,
     H2O-Danube's dh 80 windowed at 8192, DeepSeek's dh 192 in bf16 on
     the tensor cores and in f32, from its teacher-forced run, on the
     CUDA-core bucket past 128, Zamba2's scan), SDPA beside each
     attention row (a window as its mask).
  4. Fig. 6, the crash matrix and the examples, through the entry
     points a user calls: `bench.dht.bench_dht(ps=(64,))` (foMPI-A,
     foMPI-RW and RMA-RW, each scheme's four writer fractions the lanes
     of one run) equals the reference's rows (DHT_EXPECTED); prints each
     scheme's wall time, slowest lane and lane-events/s, RMA-RW's
     speedups and the DHT program's torch ops per event step.
     `bench.faults.bench_faults()` (5 kinds x 3 crash times x P seeds)
     equals the reference's payload (FAULTS_EXPECTED): zero violations,
     every survivor completed. `examples.quickstart.main("cuda")` (its
     RMA-RW and foMPI-RW runs are the simulator phase's quickstart
     configurations, checked there; its DHT line equals the reference's)
     and `examples.serve_kv.main("cuda")` (every request found, one swap
     landed, tokens in range); both DHT kernels launched in each.
  5. Lock simulator at the README's and the paper's sizes through
     `Session.run` / `Session.run_batch`: zero violations, completed,
     batch lanes bitwise equal to single runs, and seed-0 events /
     acquires / makespan bits equal to the constants below (derived from
     the JAX reference by tests/test_torch_smoke_constants.py). The
     quickstart configurations' seed-0 runs and 32-seed batch are those
     phase 4's quickstart ran. One configuration crashes a writer, so the
     full handler table (lease guards and recovery instructions) runs
     beside the crash-free one; each prints its torch ops per event step.
  6. Parameter space (`Session.grid`, the Fig. 4a / Fig. 5 benchmarks,
     the tuner), every lattice point a lane of one run: gate_rma_rw's
     18-point (T_DC, T_L, T_R) grid equals the reference's per-point
     constants below, sampled points and the slowest one equal fresh
     sessions, and the grid split into two chunks on the card equals
     the one-chunk grid, all bit for bit; `bench_rw_vs_sota` and
     `sweep_tdc` at P=64 show zero violations and every point
     completed; `tune` on `benchmarks/run.py --tune`'s default workload
     (rma_rw P=64, F_W 0.05, 4 seeds, one refine round) at 2 acquires
     per process (4 there) picks the reference's winner with its
     per-seed throughputs, which a fresh session reproduces. Prints the
     grid's torch ops per event step, wall times, and each tuning
     round's lanes and rates.
  7. locklint (`repro_torch.analysis`): every lock kind's `--quick`
     configurations, the foMPI-A DHT program (model seeds 0-3) and the
     layout lattice on the card, with zero findings and every config's
     states, edges, interleavings and cap equal to the reference's
     (LOCKLINT_EXPECTED), then every lock configuration of `--all` the
     same way; prints each config's wall time, breadth-first levels,
     widest level's lanes and states per second, and the torch ops of
     one model-checker step. The four seeded
     mutants must each be caught by the pass that owns it. The runtime
     sanitizer must run an rma_rw P=4 schedule clean (equal to the
     unchecked run) and trap a write to a padded dead counter slot.
  8. Training (`repro_torch.runtime.Trainer`) of Qwen2-0.5B and
     Mamba2-130M at full width, random f32 masters from the seed, bf16
     compute, 4 x 1024 tokens a step: first a 2-layer full-width copy of
     each, whose first step's gradients with the kernels' autograd
     Functions must match autograd through the plain versions on the
     card (norm-relative, GRAD_TOL, bf16 and f32 compute); then Qwen2 6
     steps with a checkpoint at step 4 (phase 11 resumes from it) and a
     closing one, and Mamba2 8 steps, each in a
     workdir under build/ deleted afterwards. Checks a finite loss at
     every step, a finite gradient on every parameter at step 0 and one
     not all zero on every attention / SSD parameter, the kernel
     launched once per layer in every step (Qwen2's the tensor-core
     attention), the closing checkpoint, and that a second Mamba2 run
     that faults at step 5 and recovers from its step-4 checkpoint
     (`run_with_recovery`) ends with the uninterrupted run's losses and
     parameters bit for bit. Prints step ms, tokens/s and peak memory
     beside the card's name and power limit; the training path's kernel
     rows come from step 0's layer-0 inputs.
  9. Hierarchical training (`repro_torch.parallel.hierarchical`, hier):
     2 pods on 2 x 1024 tokens each, a sync every 2 steps, 4 steps from
     `init_hier_state` (seed), full width, bf16 compute: Qwen2-0.5B with
     the exact (mean) sync and then with the int8 delta exchange on the
     same batches, then Mamba2-130M with the int8 sync, one after
     another. Checks a finite loss and grad norm at every step, synced
     [0, 1, 0, 1], every leaf's pod rows bit-equal after each sync and
     the pods apart after step 0, the kernel once per layer per pod in
     every step (48; Qwen2's all on the tensor-core attention), and the
     int8 run's parameters within 0.05 relative drift of the exact run's
     (tests/test_system.py's bound). Prints step ms, tokens/s, peak
     memory, each sync's ms and one sync's wire bytes (f32 vs int8;
     nothing moves on one card); the path's kernel rows come from layer
     0's pod-0 inputs at step 0.
 10. Dry run (`repro_torch.launch.dryrun`, dryrun) with this machine's
     torch, in a subprocess on one CPU thread started before phase 2
     and read after phase 9 (it launches nothing, and its fake process
     group of 256 / 512 ranks stays out of this process): Qwen2-0.5B x
     prefill_32k x pod16x16
     (the attention kernel's meta path), Mamba2-130M x train_4k x
     pod16x16 (ssd_scan's and its backward's, AdamW) and DeepSeek-V3 x
     decode_32k x pod2x16x16 (MoE, MLA, the pod axis), as DTensors on
     the meta device, then Qwen2-0.5B's pod-local hierarchical step
     (`lower_hier`, `--hier 4 --compress`: train_4k on pod2x16x16,
     lowered without and with the int8 sync). Prints each record's line;
     fails unless every cell is ok with its flops, bytes, collectives
     and kernel meta calls counted, and the `--hier` record is ok with
     no cross-pod wire without the sync and its amortized wire. Nothing
     runs on the card.
 11. Mesh (`Trainer(mesh=)`, mesh): phase 8's Qwen2-0.5B run resumed
     from its step-4 checkpoint on a ("data", "model") mesh of one NCCL
     rank per visible card ((1, 1) on one card: the DTensor path with
     its collectives), in a subprocess (a process group is global
     state), for the 2 steps to phase 8's closing step. Checks the
     tensor-core attention once per layer per step in the subprocess,
     the losses and the final parameters equal to phase 8's one-device
     run over the same steps within its bf16 gate (5e-2: each loss
     relative, the parameters' change over the two steps norm-relative
     as one vector; each leaf's own error is printed: the key bias's
     exact gradient is zero, so its values are rounding noise that AdamW
     scales up), and the mesh's closing checkpoint restored on one
     device with every
     leaf equal to the mesh's `full_tensor()`. Prints step ms, peak GiB
     and the restore's seconds with the card's name and power limit; the
     path's kernel row comes from layer 0's inputs at step 4.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is the card's name and power limit, and the line before that the
kernels' JSON record. Without a CUDA device, or without the repository
around it, the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
# Dense peaks of the same data sheet: bf16 on the tensor cores, and f32
# on the CUDA cores (the SSD's and f32 attention's type; TF32 would miss
# their tolerances).
H100_BF16_FLOP_S = 989e12
H100_F32_FLOP_S = 67e12

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
    # One acquire per process (the figures take 4) and P 128 (256
    # until the mesh phase came): cut for the time budget (two acquires
    # until the training phase came).
    "paper_rma_rw_128": dict(paper_default=("rma_rw", 128,
                                            dict(writer_fraction=0.02)),
                             session=dict(target_acq=1, cs_kind=0),
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
    "paper_rma_rw_128": (708, 128, 1122468534),
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


# ------------------------------------------------------------------ grid
# gate_rma_rw's (T_DC, T_L, T_R) lattice: 18 points, seed 0, one run.
GRID_AXES = ([1, 4, 16], [(64, 4), (64, 1), None], [8, 1024])
# Seed-0 (events, total_acquires, makespan as float32 bits) of the JAX
# reference's grid, point by point in (T_DC, T_L, T_R) order.
GRID_EXPECTED = (
    (717, 64, 1141365390), (717, 64, 1141365390), (898, 64, 1145644388),
    (898, 64, 1145644388), (717, 64, 1141365390), (717, 64, 1141365390),
    (648, 64, 1126613649), (606, 64, 1126613649), (733, 64, 1131331925),
    (691, 64, 1131331925), (648, 64, 1126613649), (606, 64, 1126613649),
    (759, 64, 1124253368), (632, 64, 1121782988), (847, 64, 1126363630),
    (673, 64, 1121507083), (759, 64, 1124253368), (632, 64, 1121782988))
# Grid points (d, l, r) also run as fresh sessions: an unbounded T_L
# (and the slowest point, at the lowest T_DC, alone too).
GRID_FRESH = ((1, 2, 0),)
# `benchmarks/run.py --tune`'s default workload at 1 acquire per process
# (4 there; 2 until the mesh phase came): cut for the time budget.
TUNE_SPEC = ("rma_rw", 64, dict(writer_fraction=0.05))
TUNE_ARGS = dict(seeds=(0, 1, 2, 3), refine_rounds=1, target_acq=1)
# The JAX reference's winner (LockSpec JSON) and its per-seed throughputs
# (Python floats, as float64 bits).
TUNE_EXPECTED = {
    "spec": '{"P": 64, "T_DC": 64, "T_L": [1048576, 1], "T_R": 256, '
            '"cost": {"atomic_factor": 1.35, "backoff0": 1.0, '
            '"backoff_max": 32.0, "jitter": 0.08, "lat": [0.05, 0.3, 1.7, '
            '2.1, 2.4], "occupancy": 0.4, "wake": 0.1}, "fanout": [4], '
            '"kind": "rma_rw", "role_seed": 17, "writer_fraction": 0.05}',
    "throughput_per_seed": (4699590819332489216, 4698413758312087552,
                            4698783500772311040, 4698793977271287808),
}


# ----------------------------------------------------------------- Fig. 6
# Fig. 6 at P=64: the paper's P up to 1024, cut to the card's time budget.
DHT_PS = (64,)
# The JAX reference's `benchmarks/dht_bench.bench_dht(ps=(64,))` rows.
DHT_EXPECTED = (
    {"bench": "dht", "P": 64, "F_W": 0.0, "fompi_a_us": 158.9062957763672,
     "fompi_rw_us": 204.95896911621094, "rma_rw_us": 28.030620574951172},
    {"bench": "dht", "P": 64, "F_W": 0.02, "fompi_a_us": 158.4996337890625,
     "fompi_rw_us": 657.2803955078125, "rma_rw_us": 228.51866149902344},
    {"bench": "dht", "P": 64, "F_W": 0.05, "fompi_a_us": 158.05203247070312,
     "fompi_rw_us": 1030.4765625, "rma_rw_us": 156.24978637695312},
    {"bench": "dht", "P": 64, "F_W": 0.2, "fompi_a_us": 156.39109802246094,
     "fompi_rw_us": 2533.0625, "rma_rw_us": 286.3930969238281})
# The JAX reference's `benchmarks/faults.bench_faults()` payload.
FAULTS_EXPECTED = {"crash_times_us": [0.5, 1.5, 3.0], "rows": [
    {"kind": "d_mcs", "P": 2, "n_runs": 6, "n_recovered": 3,
     "recovery_us_p50": 3.9664820432662964,
     "recovery_us_p90": 4.0547349691390995,
     "recovery_us_p99": 4.07459187746048, "total_reclaims": 3,
     "recovery_retries": 0, "violations": 0, "all_completed": True},
    {"kind": "rma_mcs", "P": 2, "n_runs": 6, "n_recovered": 6,
     "recovery_us_p50": 6.0480475425720215,
     "recovery_us_p90": 6.811111092567444,
     "recovery_us_p99": 6.853310233354568, "total_reclaims": 6,
     "recovery_retries": 0, "violations": 0, "all_completed": True},
    {"kind": "rma_rw", "P": 2, "n_runs": 6, "n_recovered": 6,
     "recovery_us_p50": 6.677282929420471,
     "recovery_us_p90": 7.796548128128052,
     "recovery_us_p99": 7.796548128128052, "total_reclaims": 30,
     "recovery_retries": 0, "violations": 0, "all_completed": True},
    {"kind": "fompi_spin", "P": 4, "n_runs": 12, "n_recovered": 0,
     "recovery_us_p50": 0.0, "recovery_us_p90": 0.0,
     "recovery_us_p99": 0.0, "total_reclaims": 0, "recovery_retries": 0,
     "violations": 0, "all_completed": True},
    {"kind": "fompi_rw", "P": 4, "n_runs": 12, "n_recovered": 4,
     "recovery_us_p50": 3.809403121471405,
     "recovery_us_p90": 3.906252992153168,
     "recovery_us_p99": 3.93568346619606, "total_reclaims": 4,
     "recovery_retries": 0, "violations": 0, "all_completed": True}]}
# The reference quickstart's DHT line: (inserted, overflow) of its 200 keys.
QUICKSTART_DHT_EXPECTED = (186, 14)
# The simulator configurations whose seed-0 runs and batch come from
# examples/quickstart (session name in its rw_demo -> configuration).
QUICKSTART_SESSIONS = {"rma_rw": "quickstart_rma_rw",
                       "fompi_rw": "quickstart_fompi_rw"}

# ------------------------------------------------------------- locklint
# (kind, config label) -> (states, edges, interleavings (counted up to
# 50000), state cap hit) of every configuration of the JAX reference's
# locklint, pinned from `PYTHONPATH=src JAX_PLATFORMS=cpu python -m
# repro.analysis.locklint --all` at commit ce3c076 (src/repro/ is the
# same in every later commit of the port); the DHT row sums its model
# seeds 0-3. tests/test_torch_locklint.py holds the rows of the quick
# configurations and of five others against the reference, and the
# whole table against the port, on the CPU.
LOCKLINT_EXPECTED = {
    ('d_mcs', 'P=2 acq=2'):
        (1453, 2646, 50000, False),
    ('d_mcs', 'P=3 acq=1'):
        (3440, 8757, 50000, False),
    ('d_mcs', 'P=2 acq=2 crash=p0'):
        (3571, 5889, 50000, False),
    ('d_mcs', 'P=3 acq=1 crash=p0'):
        (8596, 20366, 50000, False),
    ('fompi_rw', 'P=2 wf=0.5 acq=2'):
        (125, 226, 50000, False),
    ('fompi_rw', 'P=3 wf=0.34 acq=2'):
        (1459, 3958, 50000, False),
    ('fompi_rw', 'P=2 wf=0.5 acq=2 crash=p0'):
        (309, 506, 50000, False),
    ('fompi_rw', 'P=2 wf=0.5 acq=2 crash=p1'):
        (327, 522, 50000, False),
    ('fompi_rw', 'P=3 wf=0.67 acq=1 crash=p0'):
        (445, 977, 50000, False),
    ('fompi_spin', 'P=2 acq=2'):
        (65, 112, 278, False),
    ('fompi_spin', 'P=3 acq=2'):
        (425, 1080, 50000, False),
    ('fompi_spin', 'P=2 acq=2 crash=p0'):
        (161, 252, 980, False),
    ('rma_mcs', 'P=2 fanout=(1,) T_DC=1 T_L=(1, 2) T_R=67108864 acq=2'):
        (3895, 7234, 50000, False),
    ('rma_mcs', 'P=2 fanout=(2,) T_DC=1 T_L=(2, 1) T_R=67108864 acq=2'):
        (3151, 5910, 50000, False),
    ('rma_mcs', 'P=3 fanout=(3,) T_DC=1 T_L=(1, 1) T_R=67108864 acq=1'):
        (9606, 25683, 50000, False),
    ('rma_mcs', 'P=2 fanout=(1,) T_DC=1 T_L=(1, 2) T_R=67108864 acq=2 crash=p0'):
        (10150, 16689, 50000, False),
    ('rma_mcs', 'P=2 fanout=(2,) T_DC=1 T_L=(2, 1) T_R=67108864 acq=2 crash=p0'):
        (7720, 13133, 50000, False),
    ('rma_mcs', 'P=3 fanout=(3,) T_DC=1 T_L=(1, 1) T_R=67108864 acq=1 crash=p0'):
        (24409, 60426, 50000, False),
    ('rma_rw', 'P=2 fanout=(2,) T_DC=1 T_L=(1, 1) T_R=1 wf=0.5 acq=2'):
        (1316, 2518, 50000, False),
    ('rma_rw', 'P=2 fanout=(1,) T_DC=1 T_L=(1, 2) T_R=1 wf=1.0 acq=2'):
        (5319, 9930, 50000, False),
    ('rma_rw', 'P=2 fanout=(2,) T_DC=1 T_L=(1, 1) T_R=1 wf=1.0 acq=2'):
        (4425, 8438, 50000, False),
    ('rma_rw', 'P=3 fanout=(3,) T_DC=1 T_L=(1, 1) T_R=1 wf=0.34 acq=1'):
        (1988, 5178, 50000, False),
    ('rma_rw', 'P=2 fanout=(2,) T_DC=1 T_L=(1, 1) T_R=1 wf=0.5 acq=2 crash=p0'):
        (3075, 5463, 50000, False),
    ('rma_rw', 'P=2 fanout=(2,) T_DC=1 T_L=(1, 1) T_R=1 wf=0.5 acq=2 crash=p1'):
        (3043, 5434, 50000, False),
    ('rma_rw', 'P=2 fanout=(1,) T_DC=1 T_L=(1, 2) T_R=1 wf=1.0 acq=2 crash=p0'):
        (15186, 24227, 50000, False),
    ('rma_rw', 'P=2 fanout=(2,) T_DC=1 T_L=(1, 1) T_R=1 wf=1.0 acq=2 crash=p0'):
        (11923, 19813, 50000, False),
    ('fompi_a_dht', 'P=3 table=4 wf=0.34'):
        (1154, 2946, 50000, False),
}
# The rma_rw configuration the runtime sanitizer must run clean.
SANITIZED_RW = dict(kind="rma_rw", P=4, fanout=(2,), T_DC=2, T_L=(1, 2),
                    T_R=2, writer_fraction=0.5)


def f64_bits(x) -> int:
    import numpy as np
    return int(np.float64(x).view(np.uint64))


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


def dht_lookup_bytes(table_shape, keys_routed, hit) -> int:
    """Bytes dht_lookup must move on these inputs. Streamed: each lane's
    key read, its value and hit flag written (4 + 4 + 1 bytes). Table:
    device memory moves whole 32-byte sectors, so every distinct sector
    of table_keys that a valid lane's slot (key % TB in its block) falls
    in, and of table_vals that a hit lane's slot falls in (the tables
    are 32-byte aligned, 8 int32 slots a sector)."""
    import torch
    nb, TB = table_shape
    valid = keys_routed != -1
    slot = torch.where(valid, torch.remainder(keys_routed, TB), 0).long()
    sector = (torch.arange(nb, device=keys_routed.device)[:, None] * TB
              + slot) // 8
    n_keys = torch.unique(sector[valid]).numel()
    n_vals = torch.unique(sector[hit & valid]).numel()
    return 32 * (n_keys + n_vals) + 9 * keys_routed.numel()


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
    look_bytes = dht_lookup_bytes((nb, TB), qr, lgot[1])
    print(f"dht_lookup bytes: {lanes} lanes x 9 streamed + 32-byte sectors "
          f"of the table for {int((qr != -1).sum())} valid and "
          f"{int(lgot[1].sum())} hit lanes = {look_bytes}", flush=True)
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


# -------------------------------------------------------------- serving
SERVE_ARCHS = ("qwen2-0.5b", "mamba2-130m")
SERVE_B, SERVE_S, SERVE_NEW, SERVE_SWAP_AT, SERVE_TF = 4, 1024, 32, 16, 8
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}    # by input dtype
SSD_TOL = 2e-4
# Teacher-forced decode against prefill, per compute dtype: f32 holds the
# two paths to 1e-3 on every model; bf16 (the serving dtype) to the JAX
# package's 0.06 (tests/test_archs.py), gated where it holds: Qwen2 and
# the two MoE archs at their cut depth. On Mamba2 a bf16 rounding flip
# caused by the f32 scan-vs-recurrence difference (~1e-6) cascades
# through the 24 random layers to ~0.16 (the JAX reference shows the
# same: 0.065 at 6 layers on a CPU), so its bf16 figure is printed, not
# gated; its f32 figure carries the check. The deeper dense, VLM and
# hybrid archs read 0.0625-0.125 on the H100 and are printed the same
# way, each with its reason (TF_WHY).
TF_TOL = {"float32": 1e-3, "bfloat16": 0.06}
TF_GATED = {"qwen2-0.5b": ("float32", "bfloat16"),
            "mamba2-130m": ("float32",),
            "deepseek-v3-671b": ("float32", "bfloat16"),
            "arctic-480b": ("float32", "bfloat16")}
# Why an arch's bf16 figure is printed and not gated (the JAX package
# holds its 0.06 at 2-4 SMOKE layers).
TF_WHY = {"mamba2-130m": "a bf16 flip cascades through 24 random layers",
          "starcoder2-7b": "a bf16 flip cascades through 32 random layers",
          "olmo-1b": "a bf16 flip cascades through 16 random layers",
          "h2o-danube-1.8b": "a bf16 flip cascades through 24 random "
                             "layers",
          "internvl2-2b": "a bf16 flip cascades through 24 random layers "
                          "behind 256 unit-variance stub patches",
          "zamba2-2.7b": "a bf16 flip cascades through 54 random Mamba2 "
                         "layers and 9 shared-block applications"}


def close(got, want, tol: float):
    """(max |got - want|, whether |got - want| <= tol + tol |want|)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.abs()).all())


def attention_bound(q, k, v, causal: bool = True, window=None):
    """(bound ms, "bytes" or "operations", flops, bytes) of attention on
    these inputs: q, k, v read and the output written once; 4 dh
    operations per (query, key) pair the mask keeps (q.k and p.v), at
    the peak for the inputs' type: bf16 on the tensor cores, f32 on the
    CUDA cores (the CUDA-core variant's; TF32 would miss its 2e-5)."""
    import torch
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= kpos > qpos - window
    flops = 4 * dh * B * H * int(keep.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    rate = (H100_BF16_FLOP_S if q.dtype == torch.bfloat16
            else H100_F32_FLOP_S)
    return bound(flops, rate, nbytes) + (flops, nbytes)


def ssd_bound(x, dt, A, B, C, chunk: int):
    """(bound ms, "bytes" or "operations", flops, bytes) of the SSD scan
    on these inputs: x, dt, A, B, C read and y, state written once; per
    (batch, chunk) the lower triangle of C B^T (shared by the heads), per
    head its (C B^T o L)(x dt) lower triangle, (C e^cum) state^T and
    (x dt decay)^T B; at the f32 CUDA-core peak."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    pairs = chunk * (chunk + 1)          # 2 x the lower triangle
    flops = (b * (S // chunk)
             * (N * pairs + H * (P * pairs + 4 * chunk * N * P)))
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel() + b * H * P * N)
    return bound(flops, H100_F32_FLOP_S, nbytes) + (flops, nbytes)


# A kernel timed under its bound by more than this factor was mis-timed
# (the profiler lost records), not fast.
BOUND_SLACK = 1.05


def bound(flops: float, rate: float, nbytes: float):
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def teacher_forced(cfg, params, batch, dtype: str):
    """Max |decode - prefill| logit error and whether it is within
    TF_TOL[dtype], with the model computing in `dtype`: prefill
    S - SERVE_TF tokens (after a VLM's patches), then decode the next
    SERVE_TF tokens one at a time, against a full S-token prefill. Fails
    unless every logit is finite."""
    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import lm
    tokens = batch["tokens"]
    B, S = tokens.shape
    cut = S - SERVE_TF
    pre = cfg.n_patches
    saved, lm.COMPUTE_DTYPE = lm.COMPUTE_DTYPE, getattr(torch, dtype)
    try:
        with torch.no_grad():
            full, _ = lm.prefill(params, cfg, batch)
            check(bool(torch.isfinite(full).all()),
                  f"{cfg.name}: {dtype} prefill logits are not finite")
            want = full[:, pre + cut - 1:].float()
            del full
            logits, cache = lm.prefill(params, cfg,
                                       dict(batch, tokens=tokens[:, :cut]))
            got = [logits[:, -1:].float()]
            del logits
            cache = grow_cache(cfg, cache, B, pre + S)
            for t in range(cut, S):
                lg, cache = lm.decode_step(params, cfg, tokens[:, t:t + 1],
                                           cache)
                check(bool(torch.isfinite(lg).all()),
                      f"{cfg.name}: {dtype} decode logits are not finite")
                got.append(lg.float())
    finally:
        lm.COMPUTE_DTYPE = saved
    return close(torch.cat(got, dim=1), want, TF_TOL[dtype])


def kernel_counts() -> dict:
    """The serving kernels' launch counters."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    f = fa.flash_attention
    return {"flash_attention": f.launches, "flash_attention_wgmma":
            f.launches_wgmma, "flash_attention_fma": f.launches_fma,
            "ssd_scan": ssd.ssd_scan.launches}


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    f = fa.flash_attention
    f.launches = f.launches_wgmma = f.launches_fma = 0
    ssd.ssd_scan.launches = 0


@contextlib.contextmanager
def first_call(mod, name: str):
    """Inside the block, mod.<name> records its first call's (args,
    kwargs) in the list this yields."""
    kernel = getattr(mod, name)
    seen = []

    def capture(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return kernel(*args, **kwargs)

    setattr(mod, name, capture)
    try:
        yield seen
    finally:
        setattr(mod, name, kernel)


def attention_row(kind: str, args, kwargs, launches: int,
                  name: str = "") -> dict:
    """Hold attention variant `kind` against its plain version and the
    naive oracle ref.attention_ref (the TPU kernel's semantics, P in
    f32) on these inputs, time it and SDPA (a sliding window as SDPA's
    additive mask), and return its kernels-line row, named
    flash_attention_<kind> plus `name`."""
    import torch
    from torch.nn import functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = args
    dtype = str(q.dtype).removeprefix("torch.")
    tol = ATTN_TOL[dtype]
    check(fa.variant(q, k) == kind, f"layer 0's {dtype} attention inputs "
          f"take the {fa.variant(q, k)} variant, not {kind}")
    counter = f"launches_{kind}"
    before = getattr(fa.flash_attention, counter)
    got = fa.flash_attention(*args, **kwargs)
    check(getattr(fa.flash_attention, counter) == before + 1,
          f"flash_attention on {dtype} inputs did not launch the {kind} "
          "kernel")
    want = fa.flash_attention_plain(*args, **kwargs)
    err, ok = close(got, want, tol)
    ref_err, ref_ok = close(got, ref.attention_ref(*args, **kwargs), tol)
    torch.cuda.synchronize()
    qt, kt, vt = (t.transpose(1, 2) for t in args)
    causal, window = kwargs.get("causal", True), kwargs.get("window")
    mask = None
    if window is not None:       # additive, so SDPA converts nothing
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = kpos > qpos - window
        if causal:
            keep &= kpos <= qpos
        mask = torch.zeros(keep.shape, dtype=q.dtype,
                           device=q.device).masked_fill_(~keep,
                                                         float("-inf"))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    sdpa_err, _ = close(sdpa().transpose(1, 2), want, tol)
    check(ok, f"flash_attention ({kind}) differs from its plain version "
          f"by {err}")
    check(ref_ok, f"flash_attention ({kind}) differs from "
          f"ref.attention_ref by {ref_err}")
    # Kernel and SDPA by their device time (torch.profiler): a launch of
    # ~0.06 ms is as short as the host's cost per call, which CUDA events
    # around back-to-back calls would measure instead. Event times, in
    # turns (kernel, SDPA, kernel), are printed beside.
    run = lambda: fa.flash_attention(*args, **kwargs)  # noqa: E731
    bound_ms, by, flops, nbytes = attention_bound(*args, **kwargs)
    floor_ms = bound_ms / BOUND_SLACK
    passes = kernel_times(run, "", floor_ms=floor_ms)
    ms = sum(t for _, t in passes.values())
    check(ms > 0, f"torch.profiler saw no device time in flash_attention "
          f"({kind})")
    library = kernel_times(sdpa, "", floor_ms=floor_ms)
    library_ms = sum(t for _, t in library.values())
    turns = [cuda_ms(run, 20), cuda_ms(sdpa, 20), cuda_ms(run, 20)]
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(*args, **kwargs), 5)
    check(len(passes) == 1 and all(c == 1 for c, _ in passes.values()),
          f"flash_attention ({kind}) launched {passes} per call, not one "
          "kernel once")
    check(ms >= floor_ms, f"flash_attention ({kind}) timed at {ms} ms, "
          f"under its bound {bound_ms} ms: the trace lost time")
    check(library_ms >= floor_ms, f"SDPA timed at {library_ms} ms on "
          f"flash_attention ({kind})'s inputs, under their bound "
          f"{bound_ms} ms: the trace lost time")
    print(f"flash_attention ({kind}, {dtype}): {ms:.4f} ms device time "
          f"({', '.join(f'{k} x{c:g}' for k, (c, _) in passes.items())}; "
          f"CUDA events in turns: kernel {turns[0]:.4f}, SDPA "
          f"{turns[1]:.4f}, kernel {turns[2]:.4f}; plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms device time, its kernels "
          f"{sorted(library)}) on layer 0's inputs "
          f"{[tuple(t.shape) for t in args]} {kwargs}; max |kernel - "
          f"plain| {err}, |kernel - attention_ref| {ref_err}, |sdpa - "
          f"plain| {sdpa_err} (tolerance {tol}); bound {bound_ms:.4f} ms "
          f"by {by} ({flops} flop, {nbytes} bytes), "
          f"{100 * bound_ms / ms:.2f}% of the bound", flush=True)
    source = "flash_attention_wgmma" if kind == "wgmma" else "flash_attention"
    return {"name": f"flash_attention_{kind}{name}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": "src/repro/kernels/flash_attention.py:33",
            "launches": launches, "max_abs_err": max(err, ref_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def ssd_row(args, kwargs, launches: int, name: str = "") -> dict:
    """Hold ssd_scan against its plain version and the sequential oracle
    ref.ssd_ref (y and the final state) on these inputs, count and time
    the CUDA kernels of one call, and return its kernels-line row."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    kernel = ssd.ssd_scan
    got, want = kernel(*args, **kwargs), ssd.ssd_scan_plain(*args, **kwargs)
    torch.cuda.synchronize()
    errs = [close(g, w, SSD_TOL) for g, w in zip(got, want)]
    errs += [close(g, w, SSD_TOL) for g, w in zip(got, ref.ssd_ref(*args))]
    err, ok = max(e for e, _ in errs), all(o for _, o in errs)
    print(f"ssd_scan: max |kernel - plain| {max(e for e, _ in errs[:2])}, "
          f"max |kernel - ssd_ref| {max(e for e, _ in errs[2:])} "
          f"(tolerance {SSD_TOL})", flush=True)
    check(ok, f"ssd_scan differs from its plain version or ssd_ref by {err}")
    passes = kernel_times(lambda: kernel(*args, **kwargs), "ssd_")
    print(f"ssd_scan: one call launches {len(passes)} CUDA kernels "
          "(torch.profiler; ms per call): " + ", ".join(
              f"{k} x{c:g} {t:.4f}" for k, (c, t) in passes.items()),
          flush=True)
    check(len(passes) == ssd.KERNELS_PER_CALL
          and all(c == 1 for c, _ in passes.values()),
          f"ssd_scan launched {passes}, not {ssd.KERNELS_PER_CALL} kernels "
          "once each")
    turns = [cuda_ms(lambda: kernel(*args, **kwargs), 20) for _ in range(2)]
    ms = sum(turns) / 2
    plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(*args, **kwargs), 5)
    bound_ms, by, flops, nbytes = ssd_bound(*args, **kwargs)
    traced_ms = sum(t for _, t in passes.values())
    check(min(ms, traced_ms) >= bound_ms / BOUND_SLACK,
          f"ssd_scan timed at {ms} ms (traced {traced_ms} ms), under its "
          f"bound {bound_ms} ms")
    print(f"ssd_scan: {ms:.4f} ms (turns {turns[0]:.4f}, {turns[1]:.4f}; "
          f"plain {plain_ms:.4f} ms, library None ms) on layer 0's inputs "
          f"{[tuple(t.shape) for t in args]} {kwargs}; bound "
          f"{bound_ms:.4f} ms by {by} ({flops} flop, {nbytes} bytes), "
          f"{100 * bound_ms / ms:.2f}% of the bound", flush=True)
    return {"name": f"ssd_scan{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:33",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


def serve_phase(seed: int) -> list:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers, lm, ssm
    from repro_torch.serve import VersionedStore

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for arch in SERVE_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm.init_params(cfg, gen, dev)
        store = VersionedStore(params, n_workers=4, T_DC=1)
        tokens = torch.from_numpy(
            batch_for(cfg, SERVE_B, SERVE_S, 0, seed=seed)["tokens"]).to(dev)
        n_params = sum(p.numel() for p in params.parameters())
        mod, name = ((layers, "flash_attention") if cfg.family == "dense"
                     else (ssm, "ssd_scan"))
        # Teacher-forced decode against prefill (also the warm-up). Each
        # dtype's run is a counted path of its own (two prefills, so two
        # launches per layer), layer 0's kernel inputs captured: Qwen2's
        # f32 run is the path of the CUDA-core attention variant.
        tf_seen, tf_counts = {}, {}
        for dtype in ("float32", "bfloat16"):
            reset_counts()
            with first_call(mod, name) as seen:
                tf_err, tf_ok = teacher_forced(cfg, params,
                                               {"tokens": tokens}, dtype)
            tf_seen[dtype], tf_counts[dtype] = seen[0], kernel_counts()
            gated = dtype in TF_GATED[arch]
            print(f"serve {arch}: {n_params} params (f32 masters), "
                  f"{dtype} teacher-forced decode vs prefill: max |diff| "
                  f"{tf_err}, tolerance {TF_TOL[dtype]} "
                  f"({'gated' if gated else 'printed only'}), launches "
                  f"{tf_counts[dtype]}", flush=True)
            check(tf_ok or not gated, f"{arch}: {dtype} teacher-forced "
                  f"decode differs from prefill by {tf_err}")
            check(tf_counts[dtype][name] == 2 * cfg.n_layers,
                  f"{arch}: the {dtype} teacher-forced run launched {name} "
                  f"{tf_counts[dtype][name]} times, not once per layer in "
                  f"each of its two prefills ({2 * cfg.n_layers})")
        if name == "flash_attention":
            check(tf_counts["float32"]["flash_attention_fma"]
                  == 2 * cfg.n_layers,
                  f"{arch}: the f32 teacher-forced run did not take the "
                  f"CUDA-core attention variant: {tf_counts['float32']}")

        # ---- main path, counted; layer 0's kernel inputs captured ----
        version = store.version
        reset_counts()
        with first_call(mod, name) as seen:
            toks, prefill_s, decode_s = generate(
                cfg, store, {"tokens": tokens}, SERVE_NEW,
                swap_every=SERVE_SWAP_AT,
                background_swap=True)
        launches = kernel_counts()
        steps = SERVE_NEW - 1
        cache = lm.make_cache(cfg, SERVE_B, 8, device=dev)
        with torch.no_grad():
            n_ops, _ = count_ops(lambda: lm.decode_step(
                params, cfg, toks[:, :1].contiguous(), cache))
        print(f"serve {arch}: prefill {SERVE_B} x {SERVE_S} in "
              f"{prefill_s:.4f} s ({SERVE_B * SERVE_S / prefill_s:.1f} "
              f"tokens/s), {steps} decode steps x batch {SERVE_B} in "
              f"{decode_s:.4f} s ({steps * SERVE_B / decode_s:.1f} "
              f"tokens/s, {1e3 * decode_s / steps:.2f} ms/step, {n_ops} "
              f"torch ops/step), launches "
              f"{launches}, store v{version} -> v{store.version}",
              flush=True)
        check(launches[name] == cfg.n_layers,
              f"{arch}: {name} launched {launches[name]} times in one "
              f"prefill, not once per layer ({cfg.n_layers})")
        if name == "flash_attention":
            check(launches["flash_attention_wgmma"] == cfg.n_layers,
                  f"{arch}: the tensor-core flash_attention ran "
                  f"{launches['flash_attention_wgmma']} times in the bf16 "
                  f"prefill, not once per layer ({cfg.n_layers})")
        check(store.version == version + 1,
              f"{arch}: store version {version} -> {store.version}")
        check(toks.shape == (SERVE_B, SERVE_NEW)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch}: tokens out of [0, vocab) or of the wrong shape")

        # ---- each kernel against its plain version on layer 0's inputs
        if name == "flash_attention":
            rows.append(attention_row(
                "wgmma", *seen[0], launches["flash_attention_wgmma"]))
            rows.append(attention_row(
                "fma", *tf_seen["float32"],
                tf_counts["float32"]["flash_attention_fma"]))
        else:
            rows.append(ssd_row(*seen[0], launches["ssd_scan"]))
        del params, store, seen, tf_seen
        torch.cuda.empty_cache()
        print(f"serve {arch}: {time.perf_counter() - t_arch:.1f} s in all",
              flush=True)
    for arch, cut in FAMILY_ARCHS:
        rows += serve_family(arch, cut, seed)
    return rows


# The other families at full width (all layers, published widths, f32
# masters), served as the two above: 4 x 1024 prompts (InternVL2 behind
# its 256 stub patches, 1280 positions), 32 greedy tokens, a background
# swap at step 16; HuBERT, an encoder, a 4 x 1024-frame prefill. The MoE
# archs keep every expert and cut depth to fit one card: DeepSeek-V3 one
# dense MLA layer and one MoE layer of 256 experts (14.63 B params), Arctic
# one layer of 128 experts and the dense residual (14.07 B).
FAMILY_ARCHS = (
    ("starcoder2-7b", {}), ("olmo-1b", {}), ("h2o-danube-1.8b", {}),
    ("internvl2-2b", {}), ("zamba2-2.7b", {}), ("hubert-xlarge", {}),
    ("deepseek-v3-671b", {"n_layers": 2, "n_dense_layers": 1}),
    ("arctic-480b", {"n_layers": 1}),
)
# flash_attention launches of one prefill (one per attention application;
# Zamba2's shared block runs once per 6 Mamba2 layers), every one on the
# tensor-core variant (MLA's dh 192 too); the ssd_scan launches (one per
# Mamba2 layer).
ATTN_LAUNCHES = {"starcoder2-7b": 32, "olmo-1b": 16, "h2o-danube-1.8b": 24,
                 "internvl2-2b": 24, "zamba2-2.7b": 9, "hubert-xlarge": 48,
                 "deepseek-v3-671b": 2, "arctic-480b": 1}
SSD_LAUNCHES = {"zamba2-2.7b": 54}
# MoE teacher-forced runs: one 64-token row at capacity factor E / K, so
# that C = T and no (token, k) pair is dropped. At the published 1.25,
# prefill (T = B S) and decode (T = B) drop different pairs, and their
# logits differ by design (in the JAX package too).
TF_MOE_S = 64
# H2O-Danube's 4096-token window masks nothing at 1024 tokens: a 1 x 8192
# prompt, decoded past the window's edge, holds the windowed decode
# against the windowed prefill (and gives the dh 80 windowed kernel row).
WINDOW_ARCH, WINDOW_S = "h2o-danube-1.8b", 8192


def serve_family(arch: str, cut: dict, seed: int) -> list:
    """Serve one arch of FAMILY_ARCHS through `generate` (an encoder
    through the prefill step) with the checks of the two above; returns
    its kernels-line rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers, lm, mla, ssm
    from repro_torch.serve import VersionedStore, build_prefill_step

    dev = torch.device("cuda")
    t_arch = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch).scaled(**cut)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(cfg, gen, dev)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == lm.param_counts(cfg)[0],
          f"{arch}: {n_params} params, param_counts says "
          f"{lm.param_counts(cfg)[0]}")
    store = VersionedStore(params, n_workers=4, T_DC=1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_for(cfg, SERVE_B, SERVE_S, 0, seed=seed).items()}
    attn_mod = mla if cfg.attn_kind == "mla" else layers
    n_attn, n_ssd = ATTN_LAUNCHES[arch], SSD_LAUNCHES.get(arch, 0)
    cut_note = f", depth cut: {cut}" if cut else ""
    print(f"serve {arch}: {n_params} params ({4 * n_params / 1e9:.2f} GB "
          f"f32 masters){cut_note}", flush=True)
    rows = []

    def teacher_forced_runs(tf_cfg, tf_batch, label: str):
        """Both dtypes' teacher-forced runs, each a counted path; returns
        {dtype: (layer 0 attention inputs, launches)}."""
        out = {}
        for dtype in ("float32", "bfloat16"):
            reset_counts()
            with first_call(attn_mod, "flash_attention") as seen:
                err, ok = teacher_forced(tf_cfg, params, tf_batch, dtype)
            counts = kernel_counts()
            gated = dtype in TF_GATED.get(arch, ("float32",))
            why = "gated" if gated else "printed only: " + TF_WHY[arch]
            print(f"serve {arch}: {label} {dtype} teacher-forced decode vs "
                  f"prefill: max |diff| {err}, tolerance {TF_TOL[dtype]} "
                  f"({why}), launches {counts}", flush=True)
            check(ok or not gated, f"{arch}: {label} {dtype} teacher-forced "
                  f"decode differs from prefill by {err}")
            check(counts["flash_attention"] == 2 * n_attn
                  and counts["ssd_scan"] == 2 * n_ssd,
                  f"{arch}: the {label} {dtype} teacher-forced run launched "
                  f"{counts}, not {n_attn} attention and {n_ssd} ssd_scan "
                  "calls in each of its two prefills")
            out[dtype] = seen[0], counts
        return out

    window = tf = None
    if cfg.has_decode:
        tf_cfg, tf_batch, label = cfg, batch, f"{SERVE_B} x {SERVE_S}"
        if cfg.family == "moe":
            tf_cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
            tf_batch = {k: v[:1, :TF_MOE_S] for k, v in batch.items()}
            label = f"1 x {TF_MOE_S} (capacity factor E/K)"
        tf = teacher_forced_runs(tf_cfg, tf_batch, label)
        if arch == WINDOW_ARCH:
            wb = {"tokens": torch.from_numpy(batch_for(
                cfg, 1, WINDOW_S, 0, seed=seed)["tokens"]).to(dev)}
            window = teacher_forced_runs(
                cfg, wb, f"1 x {WINDOW_S} (window {cfg.sliding_window})"
            )["bfloat16"]

    # ---- main path, counted; layer 0's kernel inputs captured ----
    version = store.version
    reset_counts()
    with first_call(attn_mod, "flash_attention") as seen, \
            first_call(ssm, "ssd_scan") as seen_ssd:
        if cfg.has_decode:
            toks, prefill_s, decode_s = generate(
                cfg, store, batch, SERVE_NEW, swap_every=SERVE_SWAP_AT,
                background_swap=True)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with store.reader_view(0) as (p, _):
                logits, _ = build_prefill_step(cfg)(p, batch)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
    launches = kernel_counts()
    n_pos = SERVE_B * (cfg.n_patches + SERVE_S)
    if cfg.has_decode:
        steps = SERVE_NEW - 1
        cache = lm.make_cache(cfg, SERVE_B, cfg.n_patches + 8, device=dev)
        with torch.no_grad():
            n_ops, _ = count_ops(lambda: lm.decode_step(
                params, cfg, toks[:, :1].contiguous(), cache))
        del cache
        print(f"serve {arch}: prefill {SERVE_B} x {cfg.n_patches + SERVE_S}"
              f" positions in {prefill_s:.4f} s ({n_pos / prefill_s:.1f} "
              f"positions/s), {steps} decode steps x batch {SERVE_B} in "
              f"{decode_s:.4f} s ({1e3 * decode_s / steps:.2f} ms/step, "
              f"{n_ops} torch ops/step), launches {launches}, store "
              f"v{version} -> v{store.version}", flush=True)
        check(store.version == version + 1,
              f"{arch}: store version {version} -> {store.version}")
        check(toks.shape == (SERVE_B, SERVE_NEW)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch}: tokens out of [0, vocab) or of the wrong shape")
    else:
        print(f"serve {arch}: prefill {SERVE_B} x {SERVE_S} frames in "
              f"{prefill_s:.4f} s ({n_pos / prefill_s:.1f} frames/s), "
              f"launches {launches} (an encoder: no decode)", flush=True)
        check(tuple(logits.shape) == (SERVE_B, SERVE_S, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits {tuple(logits.shape)} are not "
              "finite or of the wrong shape")
        del logits
    check(launches["flash_attention"] == n_attn
          and launches["flash_attention_wgmma"] == n_attn
          and launches["flash_attention_fma"] == 0,
          f"{arch}: the bf16 prefill launched {launches}, not the wgmma "
          f"flash_attention once per attention application ({n_attn}) and "
          "the fma one never")
    check(launches["ssd_scan"] == n_ssd,
          f"{arch}: ssd_scan launched {launches['ssd_scan']} times in one "
          f"prefill, not once per Mamba2 layer ({n_ssd})")

    # ---- each new kernel shape against its plain version
    tag = f"/{arch}"
    if arch == "hubert-xlarge":                  # dh 80, non-causal
        rows.append(attention_row("wgmma", *seen[0],
                                  launches["flash_attention_wgmma"], tag))
    elif arch == WINDOW_ARCH:                    # dh 80, window at 8192
        rows.append(attention_row("wgmma", *window[0],
                                  window[1]["flash_attention_wgmma"],
                                  f"{tag}@{WINDOW_S}"))
    elif cfg.attn_kind == "mla":                 # dh 192
        # bf16 on the tensor cores (the main path); f32 on the CUDA-core
        # bucket past 128 (the f32 teacher-forced run, its counted path).
        rows.append(attention_row("wgmma", *seen[0],
                                  launches["flash_attention_wgmma"], tag))
        rows.append(attention_row("fma", *tf["float32"][0],
                                  tf["float32"][1]["flash_attention_fma"],
                                  f"{tag}/f32"))
    elif n_ssd:                                  # Zamba2's scan
        rows.append(ssd_row(*seen_ssd[0], launches["ssd_scan"], tag))
    del params, store, seen, seen_ssd, window, tf, batch
    torch.cuda.empty_cache()
    print(f"serve {arch}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB allocated, {time.perf_counter() - t_arch:.1f} s in all",
          flush=True)
    return rows


# ------------------------------------------------------------- training
# Two models trained at full width (random f32 masters from the seed,
# bf16 compute), 4 x 1024 tokens a step, with the port's Trainer: Qwen2
# through the tensor-core attention's forward, Mamba2 through ssd_scan's.
TRAIN_ARCHS = ("qwen2-0.5b", "mamba2-130m")
TRAIN_B, TRAIN_S = 4, 1024
TRAIN_STEPS = {"qwen2-0.5b": 6, "mamba2-130m": 8}
# Mamba2's recovered run: a fault at step 5 after a checkpoint at step 4.
TRAIN_FAULT_AT, TRAIN_CKPT_EVERY = 5, 4
# First-step gradients of a 2-layer full-width copy, with the kernels'
# autograd Functions against autograd through the plain versions on the
# card: max over parameters of |g_kernel - g_plain| / |g_plain|. bf16
# compute moves the forward's rounding (the kernels round where the
# plain versions round differently); f32 compute differs by summation
# order only.
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# The attention and SSD mixers' parameters: those whose gradient passes
# through the kernel's backward (wq, wk, wv; in_proj, conv_w, conv_b,
# A_log, dt_bias) or reads its output (wo; D, out_proj). Each must get a
# gradient that is not all zero.
KERNEL_PARAMS = {"flash_attention": ("wq", "wk", "wv", "wo"),
                 "ssd_scan": ("in_proj", "conv_w", "conv_b", "A_log",
                              "dt_bias", "D", "out_proj")}


def train_config(arch: str, seed: int):
    """Phase 8's TrainerConfig of `arch` (phase 11 resumes Qwen2's run
    with it): Qwen2 checkpoints at MESH_FROM, for phase 11."""
    from repro_torch.runtime import TrainerConfig
    return TrainerConfig(batch=TRAIN_B, seq=TRAIN_S,
                         ckpt_every=MESH_FROM if arch == MESH_ARCH else 1000,
                         log_every=1, seed=seed, warmup_steps=2,
                         total_steps=TRAIN_STEPS[arch])


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the model calls the kernels' plain versions
    (autograd differentiates them directly)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import layers, mla, ssm
    saved = (layers.flash_attention, mla.flash_attention, ssm.ssd_scan)
    layers.flash_attention = mla.flash_attention = fa.flash_attention_plain
    ssm.ssd_scan = ssd.ssd_scan_plain
    try:
        yield
    finally:
        layers.flash_attention, mla.flash_attention, ssm.ssd_scan = saved


def grad_parity(cfg, kernel: str, seed: int):
    """A 2-layer copy of cfg at full width: its first step's gradients
    with the kernels against the plain versions, in bf16 and f32
    compute."""
    import dataclasses

    import torch

    from repro_torch.data import batch_for
    from repro_torch.models import lm
    from repro_torch.train.step import init_state
    dev = torch.device("cuda")
    cut = dataclasses.replace(cfg, n_layers=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_for(cut, TRAIN_B, TRAIN_S, 0, seed=seed).items()}
    state = init_state(cut, torch.Generator(dev).manual_seed(seed), dev)
    saved = lm.COMPUTE_DTYPE
    try:
        for dtype in ("bfloat16", "float32"):
            lm.COMPUTE_DTYPE = getattr(torch, dtype)
            grads, counts = [], []
            for plain in (False, True):
                reset_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    loss, _ = lm.loss_fn(state.params, cut, batch)
                    loss.backward()
                torch.cuda.synchronize()
                counts.append(kernel_counts()[kernel])
                grads.append({k: p.grad for k, p in
                              state.params.named_parameters()})
                for p in state.params.parameters():
                    p.grad = None
            errs = {k: float((g - grads[1][k]).float().norm()
                             / grads[1][k].float().norm().clamp_min(1e-30))
                    for k, g in grads[0].items()}
            worst = max(errs, key=errs.get)
            print(f"train {cfg.name}: 2-layer copy, {dtype} compute, first "
                  f"step's gradients with the kernels vs the plain versions: "
                  f"max norm-relative error {errs[worst]:.3e} ({worst}), "
                  f"tolerance {GRAD_TOL[dtype]}; {kernel} launches "
                  f"{counts}", flush=True)
            check(counts == [cut.n_layers, 0], f"{cfg.name}: the 2-layer "
                  f"{dtype} gradient run launched {kernel} {counts} times, "
                  f"not [{cut.n_layers}, 0]")
            check(errs[worst] <= GRAD_TOL[dtype], f"{cfg.name}: {dtype} "
                  f"gradients with the kernels differ from the plain "
                  f"versions' by {errs[worst]} at {worst}")
    finally:
        lm.COMPUTE_DTYPE = saved
    del state, grads


def train_model(cfg, kernel: str, workdir: str, tc, smi: str, *,
                recover: bool = False):
    """One Trainer run at full width with the counters reset before it.
    Checks every step's launches (the kernel once per layer), step 0's
    gradients (finite everywhere, not all zero on any attention / SSD
    parameter) and finite loss at every logged step. Returns (final
    state, per-step loss {step: loss}, the kernel's launches in all,
    layer 0's kernel inputs at step 0)."""
    import json

    import numpy as np
    import torch

    from repro_torch.models import layers, ssm
    from repro_torch.runtime import Trainer
    dev = torch.device("cuda")
    mod = layers if kernel == "flash_attention" else ssm
    tr = Trainer(cfg, workdir, tc, device=dev)
    step_fn, per_step, seen = tr._step_fn, [], []

    def counted(state, batch):
        before, t0 = kernel_counts()[kernel], time.perf_counter()
        with first_call(mod, kernel) as first:
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        per_step.append((kernel_counts()[kernel] - before,
                         time.perf_counter() - t0))
        if not seen:
            seen.append(first[0])
            params = dict(state.params.named_parameters())
            for name, p in params.items():
                check(p.grad is not None and bool(torch.isfinite(
                    p.grad).all()), f"{cfg.name}: step 0 left no finite "
                    f"gradient on {name}")
            hit = [n for n in params if n.rsplit(".", 1)[-1]
                   in KERNEL_PARAMS[kernel]]
            check(len(hit) == len(KERNEL_PARAMS[kernel]) * cfg.n_layers,
                  f"{cfg.name}: {len(hit)} attention / SSD parameters")
            zero = [n for n in hit if not bool(params[n].grad.any())]
            check(not zero, f"{cfg.name}: step 0's gradient is all zero on "
                  f"{zero}")
        return state, metrics

    tr._step_fn = counted
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if recover:
        state = tr.run_with_recovery(TRAIN_STEPS[cfg.name],
                                     sleep=lambda s: None)
    else:
        state = tr.run(TRAIN_STEPS[cfg.name])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    with open(tr.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    losses = {r["step"]: r["loss"] for r in recs}
    check(all(np.isfinite(r["loss"]) for r in recs)
          and sorted(losses) == list(range(TRAIN_STEPS[cfg.name])),
          f"{cfg.name}: logged losses {[(r['step'], r['loss']) for r in recs]}")
    check(all(n == cfg.n_layers for n, _ in per_step),
          f"{cfg.name}: {kernel} launches per step {[n for n, _ in per_step]}"
          f", not {cfg.n_layers}")
    check(launches[kernel] == cfg.n_layers * len(per_step)
          and (kernel != "flash_attention" or launches[
              "flash_attention_wgmma"] == launches[kernel]),
          f"{cfg.name}: the training run's launches {launches}")
    step_s = float(np.median([dt for _, dt in per_step[1:]]))
    how = (f" (fault at step {tc.fault_at_step}, recovered)" if recover
           else "")
    print(f"train {cfg.name}{how}: {len(per_step)} steps of {TRAIN_B} x {TRAIN_S} tokens in "
          f"{wall:.1f} s (checkpoints and set-up included), step "
          f"{1e3 * step_s:.1f} ms median after the first (first "
          f"{1e3 * per_step[0][1]:.1f} ms), {TRAIN_B * TRAIN_S / step_s:.1f} "
          f"tokens/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB allocated, losses {[losses[s] for s in sorted(losses)]}, "
          f"launches {launches}; card {smi}", flush=True)
    return state, losses, launches[kernel], seen[0]


def train_phase(seed: int, smi: str, keep: list = None) -> list:
    """Trains Qwen2-0.5B (6 steps, a checkpoint at MESH_FROM and a
    closing one) and Mamba2-130M (8 steps; then a run that faults at step
    5 and recovers from the step-4 checkpoint, whose losses and
    parameters must equal the uninterrupted run's bit for bit) at full
    width with the port's Trainer, each in a workdir under build/
    deleted afterwards, but for Qwen2's when a list is given as `keep`:
    its run directory is appended there for phase 11 (whose caller
    deletes it). Gradient parity on 2-layer copies first. Returns the
    kernels-line rows of the training path."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    rows = []
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch)
        kernel = "flash_attention" if cfg.family == "dense" else "ssd_scan"
        grad_parity(cfg, kernel, seed)
        tc = train_config(arch, seed)
        work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
        try:
            state, losses, launches, seen = train_model(
                cfg, kernel, str(work / "run"), tc, smi)
            check(latest_step(str(work / "run" / "ckpt"))
                  == TRAIN_STEPS[arch], f"{arch}: no closing checkpoint")
            if arch == MESH_ARCH and keep is not None:
                keep.append(work)
                work = None
            if arch == "mamba2-130m":
                faulty = dataclasses.replace(
                    tc, fault_at_step=TRAIN_FAULT_AT,
                    ckpt_every=TRAIN_CKPT_EVERY)
                again, losses2, _, _ = train_model(
                    cfg, kernel, str(work / "recovered"), faulty, smi,
                    recover=True)
                with torch.no_grad():
                    diffs = [float((a - b).abs().max()) for a, b in zip(
                        state.params.parameters(),
                        again.params.parameters())]
                print(f"train {arch}: recovered run vs uninterrupted: "
                      f"losses equal {losses2 == losses}, max |param diff| "
                      f"{max(diffs)}", flush=True)
                check(losses2 == losses and max(diffs) == 0.0,
                      f"{arch}: the recovered run differs: losses {losses2} "
                      f"vs {losses}, max |param diff| {max(diffs)}")
                del again
            del state
        finally:
            if work is not None:
                shutil.rmtree(work, ignore_errors=True)
        args, kwargs = seen
        args = tuple(t.detach() for t in args)
        with torch.no_grad():
            if kernel == "flash_attention":
                rows.append(attention_row("wgmma", args, kwargs, launches,
                                          f"/train-{arch}"))
            else:
                rows.append(ssd_row(args, kwargs, launches, f"/train-{arch}"))
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------- hierarchical training
# Pod-local training (`parallel.hierarchical`) at full width, bf16
# compute, TRAIN_B x TRAIN_S tokens a step split over HIER_PODS pods,
# a sync every HIER_T_POD steps: (arch, int8 sync) per run, in turn.
HIER_RUNS = (("qwen2-0.5b", False), ("qwen2-0.5b", True),
             ("mamba2-130m", True))
HIER_PODS, HIER_T_POD, HIER_STEPS = 2, 2, 4
# int8 vs exact relative drift of Qwen2's parameters after HIER_STEPS:
# the reference test's bound (tests/test_system.py).
HIER_DRIFT = 0.05


@contextlib.contextmanager
def timed_syncs(times: list):
    """Inside the block every cross-pod sync appends its CUDA-event ms to
    `times`."""
    import torch

    from repro_torch.parallel import hierarchical as hier
    saved = (hier._mean_sync, hier._compressed_sync)

    def timed(fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            return out
        return run

    hier._mean_sync, hier._compressed_sync = map(timed, saved)
    try:
        yield
    finally:
        hier._mean_sync, hier._compressed_sync = saved


def hier_run(cfg, compress: bool, kernel: str, seed: int, smi: str):
    """HIER_STEPS hierarchical steps from `init_hier_state` (seed), the
    counters reset before. Checks a finite loss (the pods' mean, so every
    pod's) and grad norm at every step, the sync cadence, every leaf's
    pod rows bit-equal after each sync (the anchor's too) and the pods
    apart after step 0, the kernel once per layer per pod in every step
    (Qwen2's the tensor-core attention). Returns (state, the kernel's
    launches in all, layer 0's pod-0 kernel inputs at step 0)."""
    import numpy as np
    import torch

    from repro_torch.data import batch_for
    from repro_torch.models import layers, ssm
    from repro_torch.parallel.hierarchical import (build_hier_train_step,
                                                   init_hier_state)
    dev = torch.device("cuda")
    mod = layers if kernel == "flash_attention" else ssm
    name = f"hier {cfg.name} ({'int8' if compress else 'exact'} sync)"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state = init_hier_state(cfg, torch.Generator(dev).manual_seed(seed),
                            HIER_PODS, compress=compress, device=dev)
    step_fn = build_hier_train_step(cfg, HIER_PODS, HIER_T_POD,
                                    compress=compress, remat="none")
    per_step, losses, synced, seen, syncs, apart = [], [], [], [], [], None
    with timed_syncs(syncs):
        for step in range(HIER_STEPS):
            batch = {k: torch.from_numpy(x.reshape(
                (HIER_PODS, TRAIN_B // HIER_PODS) + x.shape[1:])).to(dev)
                for k, x in batch_for(cfg, TRAIN_B, TRAIN_S, step,
                                      seed=seed).items()}
            before, t0 = kernel_counts()[kernel], time.perf_counter()
            with first_call(mod, kernel) as first:
                state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            per_step.append((kernel_counts()[kernel] - before,
                             time.perf_counter() - t0))
            if not seen:
                args, kwargs = first[0]
                seen.append((tuple(t.detach() for t in args), kwargs))
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            check(np.isfinite(loss) and np.isfinite(gnorm),
                  f"{name}: step {step} loss {loss}, grad norm {gnorm}")
            losses.append(loss)
            synced.append(int(metrics["synced"]))
            with torch.no_grad():
                same = [all(bool(torch.equal(p[i], p[0]))
                            for i in range(1, HIER_PODS))
                        for p in state.params.values()]
                anchored = [bool(torch.equal(a[1], a[0])) for a in
                            (state.anchor.values() if compress else ())]
            if synced[-1]:
                check(all(same) and all(anchored), f"{name}: after step "
                      f"{step}'s sync {same.count(False)} parameters and "
                      f"{anchored.count(False)} anchors differ across pods")
            if step == 0:
                apart = sum(not x for x in same)
                check(apart > 0, f"{name}: the pods are equal after step 0")
    torch.cuda.synchronize()
    launches = kernel_counts()
    want = [int((s + 1) % HIER_T_POD == 0) for s in range(HIER_STEPS)]
    check(synced == want, f"{name}: synced {synced}, not {want}")
    per_layer = HIER_PODS * cfg.n_layers
    check(all(n == per_layer for n, _ in per_step),
          f"{name}: {kernel} launches per step {[n for n, _ in per_step]}, "
          f"not {per_layer}")
    check(launches[kernel] == per_layer * HIER_STEPS
          and (kernel != "flash_attention" or launches[
              "flash_attention_wgmma"] == launches[kernel]),
          f"{name}: the run's launches {launches}")
    numel = sum(p[0].numel() for p in state.params.values())
    leaves = len(state.params)
    step_s = float(np.median([dt for _, dt in per_step[1:]]))
    print(f"{name}: {HIER_PODS} pods x {TRAIN_B // HIER_PODS} x {TRAIN_S} "
          f"tokens, T_pod {HIER_T_POD}, {HIER_STEPS} steps; step "
          f"{1e3 * step_s:.1f} ms median after the first (first "
          f"{1e3 * per_step[0][1]:.1f} ms), {TRAIN_B * TRAIN_S / step_s:.1f} "
          f"tokens/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB allocated, losses {losses}, synced {synced}, leaves apart "
          f"after step 0 {apart} of {len(same)}, sync ms "
          f"{[round(t, 3) for t in syncs]}; one sync's wire bytes per pod: "
          f"f32 {4 * numel}, int8 {numel + 4 * leaves} ({numel} parameters, "
          f"{leaves} tensors; one card moves none); launches {launches}; "
          f"card {smi}", flush=True)
    return state, launches[kernel], seen[0]


def hier_phase(seed: int, smi: str) -> list:
    """Hierarchical training at full width (HIER_RUNS): Qwen2-0.5B with
    the exact and then the int8 sync on the same batches from the same
    initial state, whose parameters must end within HIER_DRIFT of each
    other, then Mamba2-130M with the int8 sync. Returns the kernels-line
    rows of the path (layer 0's pod-0 inputs at step 0)."""
    import torch

    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    rows, exact = [], None
    for arch, compress in HIER_RUNS:
        cfg = get_config(arch)
        kernel = "flash_attention" if cfg.family == "dense" else "ssd_scan"
        state, launches, (args, kwargs) = hier_run(cfg, compress, kernel,
                                                   seed, smi)
        if not compress:
            exact = {k: p.cpu() for k, p in state.params.items()}
            del state
            torch.cuda.empty_cache()
            continue
        if exact is not None:
            err = norm = 0.0
            with torch.no_grad():
                for k, p in state.params.items():
                    want = exact[k].to(dev)
                    err += float(torch.sum((want - p).double() ** 2))
                    norm += float(torch.sum(want.double() ** 2))
            drift = (err / max(norm, 1e-12)) ** 0.5
            print(f"hier {arch}: int8 vs exact sync after {HIER_STEPS} "
                  f"steps: relative parameter drift {drift:.6f} (bound "
                  f"{HIER_DRIFT})", flush=True)
            check(drift < HIER_DRIFT, f"{arch}: the int8 sync drifted "
                  f"{drift} from the exact one")
            exact = None
        del state
        torch.cuda.empty_cache()
        with torch.no_grad():
            if kernel == "flash_attention":
                rows.append(attention_row("wgmma", args, kwargs, launches,
                                          f"/hier-{arch}"))
            else:
                rows.append(ssd_row(args, kwargs, launches, f"/hier-{arch}"))
        del args
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- mesh
# Phase 11: phase 8's Qwen2 run resumed from its step-MESH_FROM
# checkpoint through `Trainer(mesh=)` on a ("data", "model") mesh of one
# NCCL rank per visible card, in a subprocess (a process group is global
# state), to the same closing step; its losses and parameters held
# against the one-device run's at phase 8's bf16 gate.
MESH_ARCH, MESH_FROM = "qwen2-0.5b", 4
MESH_TOL = GRAD_TOL["bfloat16"]
MESH_CODE = """
import sys
root, ref, work, seed, smi = sys.argv[1:]
sys.path[:0] = [root + "/src", root]
import chip_smoke
chip_smoke.mesh_world(ref, work, int(seed), smi)
"""


def mesh_world(ref: str, work: str, seed: int, smi: str):
    """The subprocess of phase 11: one rank per visible card (this
    process alone on one card, forked ranks beyond)."""
    import torch
    world = torch.cuda.device_count()
    check(world > 0, "mesh phase: no CUDA device in the subprocess")
    if world == 1:
        mesh_rank(0, 1, ref, work, seed, smi)
        return
    import torch.multiprocessing as mp
    mp.start_processes(mesh_rank, args=(world, ref, work, seed, smi),
                       nprocs=world, start_method="spawn")


def mesh_rank(rank: int, world: int, ref: str, work: str, seed: int,
              smi: str):
    """Rank `rank` of phase 11's NCCL world: resumes phase 8's Qwen2 run
    (`ref`: its run directory) from step MESH_FROM on a (world, 1)
    ("data", "model") mesh with `Trainer(mesh=)` in `work`, counting
    each step's attention launches; rank 0 then checks the closing
    checkpoint against the mesh state's `full_tensor()` on one device,
    holds losses and parameters against phase 8's, builds the path's
    kernel row and prints one JSON line of it all."""
    import json
    import os

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.runtime import Trainer
    from repro_torch.train.step import init_state
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(MESH_ARCH)
    steps = TRAIN_STEPS[MESH_ARCH]
    tr = Trainer(cfg, os.path.join(work, "run"), train_config(MESH_ARCH, seed),
                 mesh=mesh)
    restore, per_step, seen, start = [], [], [], {}
    init_or_restore, step_fn = tr._init_or_restore, tr._step_fn

    def timed_restore():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = init_or_restore()
        torch.cuda.synchronize()
        restore.append(time.perf_counter() - t0)
        with torch.no_grad():             # step MESH_FROM's parameters
            start.update((f"params/{k.replace('.', '/')}",
                          p.full_tensor().clone())
                         for k, p in state.params.named_parameters())
        return state

    def counted(state, batch):
        before = kernel_counts()
        t0 = time.perf_counter()
        with first_call(layers, "flash_attention") as first:
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        after = kernel_counts()
        per_step.append(({k: after[k] - before[k] for k in after},
                         time.perf_counter() - t0))
        if not seen:
            args, kwargs = first[0]
            seen.append((tuple(t.to_local().detach().contiguous()
                               for t in args), kwargs))
        return state, metrics

    tr._init_or_restore, tr._step_fn = timed_restore, counted
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.run(steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = kernel_counts()
    if rank != 0:
        dist.destroy_process_group()
        return
    with torch.no_grad():
        whole = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                 for k, v in _leaves(state)}
    # The mesh run's closing checkpoint, restored on one device.
    t0 = time.perf_counter()
    like = init_state(cfg, torch.Generator("cuda").manual_seed(seed),
                      "cuda")
    one, _ = load_checkpoint(os.path.join(work, "run", "ckpt"), steps, like)
    one_s = time.perf_counter() - t0
    differ = [k for k, v in _leaves(one)
              if not torch.equal(v.detach(), whole[k].detach())]
    del one, like
    # Phase 8's one-device run over the same steps: losses and params.
    def losses(run):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)}
    got, want = losses(os.path.join(work, "run")), losses(ref)
    loss_err = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
    # The two steps' change of every parameter against the one-device
    # run's, as one vector (norm-relative), and each leaf's own error.
    errs, diff2, step2 = {}, 0.0, 0.0
    t0 = time.perf_counter()
    with np.load(os.path.join(ref, "ckpt", f"step_{steps:08d}",
                              "arrays.npz")) as end:
        for k, w0 in start.items():
            v = whole[k]
            w = torch.from_numpy(end[k]).cuda()
            d = (v.float() - w).double()
            errs[k] = float(d.norm() / w.double().norm().clamp_min(1e-30))
            diff2 += float((d * d).sum())
            step2 += float(((w - w0).double() ** 2).sum())
    compare_s = time.perf_counter() - t0
    worst = max(errs, key=errs.get)
    args, kwargs = seen[0]
    with torch.no_grad():
        row = attention_row("wgmma", args, kwargs,
                            launches["flash_attention_wgmma"],
                            f"/mesh-{MESH_ARCH}")
    dist.destroy_process_group()
    print(json.dumps({
        "world": world, "restore_s": restore[0], "one_device_restore_s": one_s,
        "compare_s": compare_s, "run_s": run_s,
        "steps": [[n, dt] for n, dt in per_step], "peak_gib": peak,
        "launches": launches, "losses": got, "ref_losses": want,
        "loss_err": loss_err, "change_err": (diff2 / step2) ** 0.5,
        "param_err": errs[worst], "worst": worst,
        "differ": differ, "leaves": len(whole), "row": row}), flush=True)


def mesh_phase(seed: int, smi: str, ref: Path) -> list:
    """Phase 11: phase 8's Qwen2-0.5B run (`ref`: its run directory, with
    checkpoints at MESH_FROM and at the end) resumed from step MESH_FROM
    through `Trainer(mesh=)` on one NCCL rank per visible card, in a
    subprocess, to the same end. Fails unless the subprocess succeeds,
    the tensor-core attention ran once per layer in every step, the
    losses (relative) and the parameters' change over the steps (norm-
    relative, all leaves as one vector) equal phase 8's within MESH_TOL,
    and the mesh's closing checkpoint restores on one
    device with every leaf equal to its `full_tensor()`. Prints step ms,
    peak GiB and the restore's seconds; returns the path's kernel row
    (layer 0's inputs at step MESH_FROM)."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    cfg_layers = get_config(MESH_ARCH).n_layers
    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    try:
        ckpt = work / "run" / "ckpt" / f"step_{MESH_FROM:08d}"
        shutil.copytree(ref / "ckpt" / f"step_{MESH_FROM:08d}", ckpt,
                        copy_function=os.link)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", MESH_CODE, str(ROOT), str(ref), str(work),
             str(seed), smi], capture_output=True, text=True, cwd=ROOT,
            timeout=600)
        wall = time.perf_counter() - t0
        check(out.returncode == 0, f"mesh phase: the subprocess failed "
              f"(rc {out.returncode}): {out.stderr[-3000:]}")
        lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
        check(len(lines) == 1, f"mesh phase: no result: {out.stdout[-2000:]}")
        res = json.loads(lines[0])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    per_step = [n for n, _ in res["steps"]]
    want_steps = TRAIN_STEPS[MESH_ARCH] - MESH_FROM
    ms = [1e3 * dt for _, dt in res["steps"]]
    print(f"mesh {MESH_ARCH}: Trainer(mesh=) on {res['world']} NCCL rank(s) "
          f"(data {res['world']}, model 1), resumed from phase 8's step "
          f"{MESH_FROM} checkpoint: restore {res['restore_s']:.2f} s, "
          f"{want_steps} steps of {TRAIN_B} x {TRAIN_S} tokens, step ms "
          f"{[round(t, 1) for t in ms]}, peak {res['peak_gib']:.2f} GiB "
          f"allocated, losses {res['losses']} vs one device "
          f"{res['ref_losses']} (max relative error {res['loss_err']:.3e}), "
          f"the {want_steps} steps' parameter change vs one device's "
          f"{res['change_err']:.3e} norm-relative (gate {MESH_TOL}; worst "
          f"leaf's final value {res['param_err']:.3e}, {res['worst']}), "
          f"closing checkpoint restored on one device in "
          f"{res['one_device_restore_s']:.2f} s, Trainer.run {res['run_s']:.2f} s "
          f"(restore, steps, closing checkpoint), comparison with phase 8's "
          f"closing checkpoint {res['compare_s']:.2f} s, leaves differing from the "
          f"mesh's full_tensor() {res['differ']} of {res['leaves']}; "
          f"attention launches {res['launches']}; subprocess {wall:.1f} s; "
          f"card {smi}", flush=True)
    check(len(per_step) == want_steps and all(
        n["flash_attention_wgmma"] == n["flash_attention"] == cfg_layers
        for n in per_step), f"mesh phase: attention launches per step "
        f"{per_step}, not {cfg_layers} on the tensor-core variant in each "
        f"of {want_steps} steps")
    check(res["loss_err"] <= MESH_TOL, f"mesh phase: losses {res['losses']} "
          f"vs the one-device run's {res['ref_losses']}")
    check(res["change_err"] <= MESH_TOL, f"mesh phase: the parameters' "
          f"change differs from the one-device run's by {res['change_err']}")
    check(not res["differ"], f"mesh phase: the closing checkpoint restored "
          f"on one device differs from the mesh state at {res['differ']}")
    torch.cuda.empty_cache()
    return [res["row"]]


def mesh_phase_alone(seed: int, smi: str) -> list:
    """Phase 11 without the other phases (after `build.timed_build()`):
    phase 8's one-device Qwen2-0.5B run first, then `mesh_phase` on it.
    Returns both paths' kernel rows."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        cfg = get_config(MESH_ARCH)
        _, _, launches, (args, kwargs) = train_model(
            cfg, "flash_attention", str(work / "run"),
            train_config(MESH_ARCH, seed), smi)
        rows = [attention_row("wgmma", tuple(t.detach() for t in args),
                              kwargs, launches, f"/train-{MESH_ARCH}")]
        return rows + mesh_phase(seed, smi, work / "run")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- dry run
# (arch, shape, multi_pod) cells lowered by phase 10, and the kernels'
# meta-path calls each must make (remat "dots" recomputes the forward).
DRYRUN_CELLS = (("qwen2_0p5b", "prefill_32k", False),
                ("mamba2_130m", "train_4k", False),
                ("deepseek_v3_671b", "decode_32k", True))
DRYRUN_KERNELS = {"qwen2_0p5b": {"flash_attention": 24},
                  "mamba2_130m": {"ssd_scan": 48, "ssd_scan_backward": 24},
                  "deepseek_v3_671b": {}}
# The pod-sync step lowered with `--hier` (arch, T_pod, int8 sync).
DRYRUN_HIER = ("qwen2_0p5b", 4, True)
DRYRUN_CODE = """
import json, time
t0 = time.perf_counter()
from repro_torch.launch import dryrun
for arch, shape, multi_pod in CELLS:
    print(json.dumps(dryrun.lower_cell(arch, shape, multi_pod)), flush=True)
arch, T_pod, compress = HIER
print(json.dumps(dryrun.lower_hier(arch, T_pod, compress=compress)),
      flush=True)
print("seconds", time.perf_counter() - t0)
"""


def start_dryrun():
    """Starts DRYRUN_CELLS' dry run in a subprocess on one CPU thread
    (it runs beside the card's phases: it launches nothing) and returns
    (process, its stdout file, its stderr file)."""
    import os
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         DRYRUN_CODE.replace("CELLS", repr(DRYRUN_CELLS)).replace(
             "HIER", repr(DRYRUN_HIER))],
        stdout=out, stderr=err, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    return proc, out, err


def dryrun_phase(started):
    """The dry run (`repro_torch.launch.dryrun.lower_cell`) of
    DRYRUN_CELLS over a fake 256 / 512-rank world with this machine's
    torch, in the subprocess `start_dryrun` started, so that the fake
    process group stays out of this process. Prints each record's line;
    fails unless every cell is ok with nonzero flops, bytes and
    collectives, the mesh and chips asked for, and its kernels'
    meta-path calls (DRYRUN_KERNELS)."""
    from repro_torch.launch.dryrun import fmt_hier_line, fmt_line
    proc, out, err = started
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=600)
    finally:
        proc.kill()
    err.seek(0)
    check(proc.returncode == 0, f"dry run failed: {err.read()[-3000:]}")
    out.seek(0)
    lines = out.read().splitlines()
    secs = [line.split()[1] for line in lines if line.startswith("seconds")]
    print(f"dryrun: the subprocess ran {float(secs[0]):.1f} s beside phases "
          f"2-9; waited {time.perf_counter() - t0:.1f} s for it at the end",
          flush=True)
    recs = [json.loads(line) for line in lines if line.startswith("{")]
    check(len(recs) == len(DRYRUN_CELLS) + 1, f"dry run: {len(recs)} "
          f"records for {len(DRYRUN_CELLS)} cells and the --hier step")
    hier = recs.pop()
    arch, T_pod, compress = DRYRUN_HIER
    print(f"dryrun: {fmt_hier_line(hier, T_pod, compress)}", flush=True)
    check(hier["status"] == "ok" and hier["arch"] == arch
          and hier["mode"] == f"hier_T{T_pod}" + "_int8" * compress
          and hier["collectives_never"]["cross_pod_wire_bytes"] == 0
          and hier["cross_pod_bytes_per_sync"] > 0
          and hier["amortized_wire_bytes"] == hier["wire_nosync"]
          + hier["cross_pod_bytes_per_sync"] / T_pod,
          f"dry run --hier {T_pod}: {hier}")
    print(f"dryrun: {arch} --hier {T_pod}{' --compress' * compress}: wire "
          f"without a sync {hier['wire_nosync']:.6e} B, one sync's cross-pod "
          f"{hier['cross_pod_bytes_per_sync']:.6e} B, flops "
          f"{hier['flops']:.4e}, bytes {hier['bytes']:.4e}", flush=True)
    for rec, (arch, shape, multi_pod) in zip(recs, DRYRUN_CELLS):
        print(f"dryrun: {fmt_line(rec)}", flush=True)
        check(rec["status"] == "ok", f"dry run {arch} x {shape}: "
              f"{rec.get('error', rec.get('reason'))}")
        check((rec["arch"], rec["shape"], rec["chips"]) ==
              (arch, shape, 512 if multi_pod else 256),
              f"dry run: record {rec['arch']} x {rec['shape']}")
        check(rec["flops"] > 0 and rec["bytes"] > 0
              and sum(rec["collectives"]["counts"].values()) > 0,
              f"dry run {arch} x {shape}: counted nothing")
        calls = {k: v["calls"] for k, v in rec["kernels"].items()}
        check(calls == DRYRUN_KERNELS[arch], f"dry run {arch} x {shape}: "
              f"kernel meta calls {calls}, want {DRYRUN_KERNELS[arch]}")
        print(f"dryrun: {arch} x {shape} lowered in {rec['lower_s']} s, "
              f"flops {rec['flops']:.4e}, bytes {rec['bytes']:.4e}, "
              f"collectives {rec['collectives']['counts']}, state "
              f"{rec['state_bytes_per_device_lowered']} B/device (plan "
              f"{rec['state_bytes_per_device']})", flush=True)


# Traces with no record of the timed kernels that kernel_times takes
# again, back to back, on top of its tries.
EMPTY_TRACES = 50


def kernel_times(fn, prefix: str, n: int = 10, tries: int = 5,
                 floor_ms: float = 0.0) -> dict:
    """{CUDA kernel: (launches per call, device ms per call)} of fn(),
    for the kernels whose name contains `prefix`, from torch.profiler
    over n calls after one warm-up. Only the device is traced, so no
    host op also carries its kernels' time. The profiler can drop a
    kernel's records (one run saw 2 of 10 launches; kernels of 0.1-1 ms
    lost 1-3 of 10 in every trace; right after a training run the first
    2-5 traces held no record at all, and so did every trace taken a
    second after the one before: up to EMPTY_TRACES such traces are
    taken again at once, on top of `tries`) or time whole launches short (one
    trace put SDPA at half its CUDA-event time, under its bound): a
    trace that recorded none of these kernels, where some kernel's
    launches are not a whole number per call, or whose kernels sum to
    less than `floor_ms` per call, is taken again, and after `tries`
    each kernel is timed by its mean over its recorded launches, times
    its launches per call rounded (at least 1). A time the trace still
    gets wrong shows against the caller's bound (BOUND_SLACK); a kernel
    that no trace recorded fails the caller's check of its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    empty = 0
    while tries:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for ev in prof.key_averages():
            # "void (anonymous namespace)::ssd_cb<true>(float const*, ...)"
            found = re.search(r"(\w+(?:<[^>(]*>)?)\(", ev.key)
            name = found.group(1) if found else ev.key
            if prefix not in name:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                out[name] = (ev.count / n, us / n / 1e3)
                counts[name] = (ev.count, us)
        total = sum(t for _, t in out.values())
        if (out and all(c % n == 0 for c, _ in counts.values())
                and total >= floor_ms):
            return out
        print(f"  torch.profiler dropped launches or time: {out} ({total} ms "
              f"per call, floor {floor_ms} ms); tracing again", flush=True)
        if not counts and empty < EMPTY_TRACES:
            # A trace with no record of these kernels (seen in runs of
            # 2-5 right after a training run, and after every trace that
            # followed a pause of a second) does not count against
            # `tries`; the next is taken at once.
            empty += 1
            continue
        tries -= 1
    per_call = {k: max(1, round(c / n)) for k, (c, _) in counts.items()}
    print(f"  timing {sorted(counts)} by the mean over their recorded "
          f"launches {({k: c for k, (c, _) in counts.items()})}",
          flush=True)
    return {k: (per_call[k], us / c * per_call[k] / 1e3)
            for k, (c, us) in counts.items()}


def count_sass(lib: Path, opcode: str) -> int:
    """How many SASS instructions of `opcode` the built library holds
    (cuobjdump, from the CUDA toolkit beside nvcc)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum(f" {opcode}" in line for line in sass.splitlines())


def count_ops(fn, device_type: str = "cuda"):
    """(torch ops that fn() dispatches, those with a tensor on the
    card). Kernels launched through ctypes are not torch ops."""
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

    with Count() as c:
        fn()
    return c.all, c.device


def ops_per_step(run, device_type: str = "cuda"):
    """Torch ops dispatched per event step of `run(steps)` (seed 0 cut
    at `steps` events), in all and with a tensor on the card: the
    difference between a 128- and a 64-step run over 64, so set-up and
    summary cancel. `run` builds its session or program anew on every
    call, so both runs build their merge plan; an uncounted 64-step run
    first creates the constants the engine caches for the whole process
    (`engine.scalar`), which would otherwise count in whichever
    configuration needs them first. The engine is launch-bound, so
    this is its cost model."""
    run(64)
    counts = [count_ops(lambda: run(steps), device_type)
              for steps in (64, 128)]
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


def bits(x) -> int:
    """A float32 tensor's bits."""
    import numpy as np
    return int(np.asarray(x.cpu(), np.float32).view(np.uint32))


def same(a, b) -> bool:
    """Every leaf of two Metrics equal, bit for bit."""
    import torch
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def timed(fn):
    """(fn(), its wall time in s, the card's work included)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sim_phase(from_examples: dict):
    """`from_examples`: configuration name -> {"session", "runs": {seed:
    (Metrics, wall s)}, "batch": (Metrics, wall s)} of runs an example
    made on this card; they are checked here and not run again."""
    from repro_torch.core import LockSpec, Session, engine, metrics_at
    from repro_torch.core.cost import CostModel

    for name, cfg in SIM_CONFIGS.items():
        spec = make_spec(LockSpec, CostModel, cfg)
        ex = from_examples.get(name, {})
        sess = ex.get("session") or Session(spec, **cfg["session"])
        n_all, n_dev = ops_per_step(lambda steps: run_seed(Session(
            spec, max_events=steps, **cfg["session"]), engine, cfg, 0))
        table = "full" if "fault" in cfg else "crash-free"
        print(f"sim {name}: {n_all:.1f} torch ops per event step, "
              f"{n_dev:.1f} of them on the card ({table} handler table)",
              flush=True)
        singles = {}
        for seed in ((0, 1) if cfg.get("batch") else (0,)):
            if seed in ex.get("runs", {}):
                (m, dt), where = ex["runs"][seed], " (examples.quickstart)"
            else:
                m, dt = timed(lambda: run_seed(sess, engine, cfg, seed))
                where = ""
            singles[seed] = m
            ev = int(m.events)
            print(f"sim {name} run({seed}){where}: events {ev}, acquires "
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
            if "batch" in ex:
                (mb, dt), where = ex["batch"], " (examples.quickstart)"
                check(mb.events.numel() == n, f"{name}: the example's batch "
                      f"has {mb.events.numel()} lanes, not {n}")
            else:
                mb, dt = timed(lambda: sess.run_batch(range(n)))
                where = ""
            steps = int(mb.events.max())
            print(f"sim {name} run_batch({n}){where}: events "
                  f"{int(mb.events.min())}"
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


@contextlib.contextmanager
def call_log(owner, *names):
    """Inside the block, every call of owner.<name>, for each of `names`,
    appends (name, args, kwargs, result, wall s with the card's work
    included) to the list this yields."""
    saved = {n: getattr(owner, n) for n in names}
    log = []

    def logged(name, fn):
        def call(*args, **kwargs):
            out, dt = timed(lambda: fn(*args, **kwargs))
            log.append((name, args, kwargs, out, dt))
            return out
        return call

    for n, fn in saved.items():
        setattr(owner, n, logged(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(owner, n, fn)


def grid_phase():
    from repro_torch.bench import locks, thresholds
    from repro_torch.core import LockSpec, Session, metrics_at
    from repro_torch.core.cost import CostModel
    from repro_torch.core.tuner import tune

    # ---- gate grid: 18 points x seed 0 as lanes of one run ----
    cfg = SIM_CONFIGS["gate_rma_rw"]
    spec = make_spec(LockSpec, CostModel, cfg)
    sess = Session(spec, **cfg["session"])
    n_all, n_dev = ops_per_step(lambda steps: Session(
        spec, max_events=steps, **cfg["session"]).grid(*GRID_AXES,
                                                      seeds=[0]))
    print(f"grid gate_rma_rw: {n_all:.1f} torch ops per event step, "
          f"{n_dev:.1f} of them on the card (18 points, crash-free table)",
          flush=True)
    m, dt = timed(lambda: sess.grid(*GRID_AXES, seeds=[0]))
    shape = tuple(len(a) for a in GRID_AXES)
    points = [(d, l, r) for d in range(shape[0]) for l in range(shape[1])
              for r in range(shape[2])]
    got = tuple((int(m.events[p + (0,)]), int(m.total_acquires[p + (0,)]),
                 bits(m.makespan[p + (0,)])) for p in points)
    steps = int(m.events.max())
    print(f"grid gate_rma_rw: 18 points in {dt:.2f} s, {steps} event "
          f"steps ({steps / dt:.1f} steps/s, {int(m.events.sum()) / dt:.1f} "
          f"lane-events/s); (events, acquires, makespan bits) per point: "
          f"{got}", flush=True)
    check(int(m.violations.sum()) == 0 and bool(m.completed.all()),
          "gate grid: violations or not completed")
    check(got == GRID_EXPECTED, f"gate grid points differ from the "
          f"reference: {got}, reference {GRID_EXPECTED}")
    slowest = points[max(range(len(points)), key=lambda i: got[i][0])]
    for d, l, r in sorted(set(GRID_FRESH) | {slowest}):
        fresh, dt1 = timed(lambda: Session(spec.replace(
            T_DC=GRID_AXES[0][d], T_L=GRID_AXES[1][l], T_R=GRID_AXES[2][r]),
            **cfg["session"]).run_batch([0]))
        point = (GRID_AXES[0][d], GRID_AXES[1][l], GRID_AXES[2][r])
        print(f"grid gate_rma_rw: point {point} alone (fresh session): "
              f"{int(fresh.events[0])} events in {dt1:.2f} s"
              + (" (the grid's slowest point)" if (d, l, r) == slowest
                 else ""), flush=True)
        check(same(metrics_at(fresh, 0), metrics_at(m, d, l, r, 0)),
              f"gate grid point {point} differs from a fresh session")
    m2, dt2 = timed(lambda: sess.grid(*GRID_AXES, seeds=[0],
                                      devices=["cuda:0", "cuda:0"]))
    print(f"grid gate_rma_rw: two chunks on cuda:0 (in turn) in "
          f"{dt2:.2f} s", flush=True)
    check(same(m2, m), "the two-chunk grid differs from the one-chunk grid")

    # ---- Fig. 5 and Fig. 4a at P=64 ----
    rows, dt = timed(lambda: locks.bench_rw_vs_sota(
        ps=(64,), fws=(0.002, 0.02, 0.05)))
    print(f"fig5 bench_rw_vs_sota P=64 in {dt:.2f} s:", flush=True)
    for row in rows:
        print(f"  {row}", flush=True)
    check(all(r["completed"] for r in rows), "fig5: a point did not complete")
    tput = {(r["kind"], r["F_W"]): r["throughput_per_s"] for r in rows}
    print("fig5 RMA-RW / foMPI-RW throughput per F_W: " + ", ".join(
        f"{fw}: {tput['rma_rw', fw] / tput['fompi_rw', fw]:.3f}"
        for fw in (0.002, 0.02, 0.05)), flush=True)
    rows, dt = timed(lambda: thresholds.sweep_tdc(ps=(64,)))
    print(f"fig4a sweep_tdc P=64 in {dt:.2f} s:", flush=True)
    for row in rows:
        print(f"  {row}", flush=True)
    check(all(r["completed"] for r in rows), "fig4a: a point did not "
          "complete")

    # ---- the tuner at P=64: every round one grid of 4 seeds ----
    kind, P, kw = TUNE_SPEC
    with call_log(Session, "grid") as calls:
        res, dt = timed(lambda: tune(LockSpec.paper_default(kind, P, **kw),
                                     **TUNE_ARGS))
    log = [(wall, m.events.numel(), int(m.events.max()),
            int(m.events.sum())) for _, _, _, m, wall in calls]
    for i, (wall, lanes, steps, events) in enumerate(log):
        print(f"tune round {i + 1}: {lanes} lanes in {wall:.2f} s, {steps} "
              f"event steps ({steps / wall:.1f} steps/s, "
              f"{events / wall:.1f} lane-events/s)", flush=True)
    per_seed = tuple(f64_bits(x) for x in res.throughput_per_seed)
    print(f"tune: {dt:.2f} s, {res.n_points} points, winner {res.spec} "
          f"at {res.throughput} acquires/s, per seed "
          f"{res.throughput_per_seed}", flush=True)
    check(len(log) == 2 and log[0][1] == 36 * 4 and log[1][1] <= 27 * 4,
          f"tune rounds ran {[e[1] for e in log]} lanes, not 144 and <= 108")
    check(res.spec.to_json() == TUNE_EXPECTED["spec"]
          and per_seed == TUNE_EXPECTED["throughput_per_seed"],
          f"tune winner {res.spec.to_json()} {per_seed} differs from the "
          f"reference's {TUNE_EXPECTED}")
    rerun = Session(res.spec, target_acq=TUNE_ARGS["target_acq"]).run_batch(
        list(res.seeds))
    check(tuple(f64_bits(x) for x in rerun.throughput.cpu().numpy())
          == per_seed, "the tuned spec rerun on a fresh session differs")


def dht_counts() -> dict:
    from repro_torch.kernels import dht_probe
    return {"dht_insert": dht_probe.dht_insert.launches,
            "dht_lookup": dht_probe.dht_lookup.launches}


def reset_dht_counts():
    from repro_torch.kernels import dht_probe
    dht_probe.dht_insert.launches = dht_probe.dht_lookup.launches = 0


def fig6_phase() -> dict:
    """Fig. 6 at P=64, the crash matrix, and the quickstart and serve_kv
    examples. Returns the quickstart's Session runs by simulator
    configuration (see `sim_phase`)."""
    import torch

    from repro_torch.bench import dht, faults
    from repro_torch.core import LockSpec, Session, engine
    from repro_torch.core.cost import CostModel
    from repro_torch.examples import quickstart, serve_kv

    # ---- Fig. 6: each scheme's F_W values as the lanes of one run ----
    with call_log(dht, "run_fompi_a", "run_locked") as calls:
        rows, dt = timed(lambda: dht.bench_dht(ps=DHT_PS))
    print(f"fig6 bench_dht P={DHT_PS} in {dt:.2f} s:", flush=True)
    for name, args, _, m, wall in calls:
        scheme = "fompi_a" if name == "run_fompi_a" else args[0]
        steps, events = int(m.events.max()), int(m.events.sum())
        print(f"  {scheme}: {m.events.numel()} lanes (F_W "
              f"{list(args[2 if name == 'run_locked' else 1])}) in "
              f"{wall:.2f} s, slowest lane {steps} events, events per lane "
              f"{m.events.reshape(-1).tolist()}, "
              f"{events / wall:.1f} lane-events/s", flush=True)
        check(int(m.violations.sum()) == 0 and bool(m.completed.all()),
              f"fig6 {scheme}: violations or not completed")
    for row in rows:
        print(f"  {row}", flush=True)
    check(rows == list(DHT_EXPECTED), f"fig6 rows differ from the "
          f"reference's: {rows}, reference {DHT_EXPECTED}")
    print("fig6 RMA-RW speedup (total time) over foMPI-RW / foMPI-A per "
          "F_W: " + ", ".join(
              f"{r['F_W']}: {r['fompi_rw_us'] / r['rma_rw_us']:.3f} / "
              f"{r['fompi_a_us'] / r['rma_rw_us']:.3f}" for r in rows),
          flush=True)
    machine, layout, prog, masks = dht.fompi_a_setup(64, (0.05,))
    env = engine.make_env(machine, layout, is_writer=masks[0], target_acq=4)
    n_all, n_dev = ops_per_step(lambda steps: engine.run_sim(
        prog, env, layout, seed=0, max_events=steps))
    print(f"fig6 fompi_a_dht P=64 F_W 0.05: {n_all:.1f} torch ops per event "
          f"step, {n_dev:.1f} of them on the card (crash-free handler "
          "table)", flush=True)

    # ---- the crash matrix: each (kind, crash time) one run of P lanes
    with call_log(engine, "run_sim_batch") as calls:
        payload, dt = timed(lambda: faults.bench_faults(quick=False))
    print(f"faults bench_faults (quick=False) in {dt:.2f} s, {len(calls)} "
          f"runs, their events per lane: "
          f"{[c[3].events.tolist() for c in calls]}", flush=True)
    for row in payload["rows"]:
        print(f"  {row}", flush=True)
    check(all(r["violations"] == 0 and r["all_completed"]
              for r in payload["rows"]),
          "faults: a violation, or a survivor did not complete")
    check(payload == FAULTS_EXPECTED, f"faults payload differs from the "
          f"reference's: {payload}")

    # ---- examples/quickstart: its runs are sim_phase's quickstart ones
    reset_dht_counts()
    with call_log(Session, "run", "run_batch") as calls:
        qs, dt = timed(lambda: quickstart.main("cuda"))
    launches = dht_counts()
    print(f"examples.quickstart in {dt:.2f} s, dht launches {launches}",
          flush=True)
    check(all(n > 0 for n in launches.values()),
          f"the quickstart's DHT did not launch both kernels: {launches}")
    d = qs["dht"]
    check((d["inserted"], d["overflow"]) == QUICKSTART_DHT_EXPECTED
          and d["all_found"] and d["values_ok"],
          f"quickstart DHT {d}, reference {QUICKSTART_DHT_EXPECTED}")
    check([c[0] for c in calls] == ["run", "run_batch", "run"],
          f"quickstart ran {[c[0] for c in calls]}")
    runs = {}
    for method, args, kwargs, m, wall in calls:
        sess = args[0]
        name = QUICKSTART_SESSIONS[next(
            k for k, v in qs["sessions"].items() if v is sess)]
        cfg = SIM_CONFIGS[name]
        check(sess.spec == make_spec(LockSpec, CostModel, cfg)
              and all(getattr(sess, k) == v
                      for k, v in cfg["session"].items()),
              f"the quickstart's {name} session is not the configuration's")
        entry = runs.setdefault(name, {"session": sess, "runs": {}})
        if method == "run":
            entry["runs"][kwargs.get("seed", args[1] if len(args) > 1
                                     else 0)] = (m, wall)
        else:
            entry["batch"] = (m, wall)

    # ---- examples/serve_kv: decode + request DHT + background swap ----
    reset_dht_counts()
    out, dt = timed(lambda: serve_kv.main("cuda"))
    launches = dht_counts()
    toks = out["tokens"]
    print(f"examples.serve_kv in {dt:.2f} s, dht launches {launches}, "
          f"store v{out['version']}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"serve_kv's DHT did not launch both kernels: {launches}")
    check(bool(out["found"].all()) and torch.equal(
        out["slots"].cpu(), torch.arange(serve_kv.BATCH, dtype=torch.int32)),
          "serve_kv: a request was not found in its slot")
    check(out["version"] == 1, f"serve_kv: store version {out['version']}")
    check(tuple(toks.shape) == (serve_kv.BATCH, serve_kv.DECODE_STEPS)
          and bool(((toks >= 0) & (toks < out["vocab"])).all()),
          "serve_kv: tokens out of [0, vocab) or of the wrong shape")
    return runs


def model_step_ops(program, env, layout, victim) -> float:
    """Torch ops that one model-checker step dispatches (one `_exec`
    call over the initial state's enabled processes, the state's copy
    to the card and the successors' copy back included), after an
    uncounted call that builds the merge plan and cached constants."""
    import numpy as np

    from repro_torch.analysis import model
    ex = model.Explorer(program, env, layout, crash_victim=victim)
    c0 = ex.init_canon()
    cols = model.Canon(*(np.asarray(x)[None] for x in c0))
    _, ps = np.nonzero(~(cols.done | cols.crashed))
    cols = model.Canon(*(x[np.zeros(len(ps), int)] for x in cols))
    ex.successors(cols, ps)
    return count_ops(lambda: ex.successors(cols, ps))[0]


def locklint_phase():
    """locklint on the card: every configuration of `--all`, the DHT
    program and the layout lattice in one pass (zero findings, counts ==
    LOCKLINT_EXPECTED; the quick subset's time summed from it), the four
    seeded mutants (each caught by its pass) and the runtime sanitizer
    (a clean run equal to the unchecked one; the dead-counter write
    trapped)."""
    import numpy as np

    from repro_torch.analysis import locklint, mutants
    from repro_torch.core import LockSpec, Session, engine
    from repro_torch.core.engine import DONE, Effect, Instr, Program
    from repro_torch.core.programs.dht import FompiADHT
    from repro_torch.core.window import build_layout

    def every_config():
        stats, findings = [], []
        for kind in sorted(locklint.CONFIGS):
            f, st = locklint.check_kind(kind, device="cuda")
            findings += f
            stats += st
        f, st = locklint.check_dht(device="cuda")
        findings += f + locklint.check_layout_lattice()
        return stats + st, findings

    (stats, findings), dt = timed(every_config)
    print(f"locklint --all (and the layout lattice): {len(stats)} configs, "
          f"{sum(st.n_states for st in stats)} states in {dt:.2f} s, "
          f"{len(findings)} findings", flush=True)
    for f in findings:
        print(f"  {f}", flush=True)
    check(not findings, f"locklint: {len(findings)} findings")
    for st in stats:
        key = (st.kind, st.config)
        got = (st.n_states, st.n_edges, st.n_interleavings, st.capped)
        print(f"  {st.kind} {st.config}: {st.n_states} states, "
              f"{st.n_edges} edges, {st.n_interleavings}"
              f"{'+' if st.interleavings_capped else ''} interleavings; "
              f"{st.seconds:.2f} s, {st.levels} levels, widest "
              f"{st.widest} lanes, {st.n_states / st.seconds:.0f} "
              "states/s", flush=True)
        check(got == LOCKLINT_EXPECTED.get(key),
              f"locklint {key}: {got}, reference {LOCKLINT_EXPECTED.get(key)}")
    check(len(stats) == len(LOCKLINT_EXPECTED),
          f"locklint ran {len(stats)} configs, LOCKLINT_EXPECTED holds "
          f"{len(LOCKLINT_EXPECTED)}")
    # The --quick subset (the DHT program is in it) from the same pass.
    quick = {(k, c.label) for k, cfgs in locklint.CONFIGS.items()
             for c in cfgs if c.quick}
    sub = [st for st in stats
           if (st.kind, st.config) in quick or st.kind == "fompi_a_dht"]
    print(f"locklint --all --quick subset: {len(sub)} configs, "
          f"{sum(st.n_states for st in sub)} states in "
          f"{sum(st.seconds for st in sub):.2f} s", flush=True)

    # Torch ops per model-checker step, one quick configuration of each
    # program: the crash-free and the full handler table.
    for kind in sorted(locklint.CONFIGS):
        for cfg in [c for c in locklint.CONFIGS[kind] if c.quick]:
            s = Session(cfg.spec(), target_acq=cfg.target_acq, cs_kind=0,
                        think=False)
            n = model_step_ops(s.program, s.env, s.layout, cfg.crash_victim)
            print(f"locklint {kind} {cfg.label}: {n} torch ops per model "
                  "step", flush=True)
    spec = LockSpec(kind="fompi_spin", P=3)
    machine = spec.machine()
    layout = spec.layout(machine, extra_words=5)
    W = layout.W
    mask = np.array([True, False, False])
    n = model_step_ops(
        FompiADHT(np.arange(W - 5, W - 1), W - 1, mask),
        engine.make_env(machine, layout, is_writer=mask, target_acq=2),
        layout, None)
    print(f"locklint fompi_a_dht P=3: {n} torch ops per model step",
          flush=True)

    # ---- the seeded mutants: each caught by the pass that owns it ----
    for cls in mutants.OWNERS:
        s = Session(LockSpec(kind="fompi_spin", P=2), target_acq=2,
                    cs_kind=0, think=False)
        prog = cls()
        found, dt = timed(lambda: locklint.check_config(
            prog, s.env, s.layout, prog.meta(s.env), "mutant")[0])
        print(f"locklint mutant {cls.__name__}: {len(found)} findings in "
              f"{dt:.2f} s, caught by {mutants.OWNERS[cls][0]}: "
              f"{mutants.caught(cls, found)}", flush=True)
        check(mutants.caught(cls, found),
              f"mutant {cls.__name__} not caught: {[str(f) for f in found]}")

    # ---- the runtime sanitizer ---------------------------------------
    s = Session(LockSpec(**SANITIZED_RW), target_acq=2, cs_kind=0,
                think=False)
    plain, dt0 = timed(lambda: s.run(0))
    with engine.runtime_checks(True):
        checked, dt1 = timed(lambda: s.run(0))
    print(f"sanitizer rma_rw P=4: clean, events {int(checked.events)}; "
          f"{dt0:.2f} s unchecked, {dt1:.2f} s checked", flush=True)
    check(bool(checked.completed) and int(checked.violations) == 0
          and same(checked, plain), "sanitizer: the checked run differs")
    machine = LockSpec(kind="fompi_spin", P=2).machine()
    lay = build_layout(machine, T_DC=1, pad_counters_to=machine.P + 2)
    env = engine.make_env(machine, lay, is_writer=np.ones(2, bool),
                          target_acq=1)
    dead = int(np.asarray(lay.arrive_w)[-1])
    prog = Program(env, (
        Instr(lambda c: Effect(dur=1.0, writes=(dead,), next_pc=1,
                               stores=((dead, c.win(dead) + 1),))),
        Instr(lambda c: Effect(dur=0.0, next_pc=1), DONE)))
    st0 = engine.init_state(env, lay, np.zeros(2, np.int32), 1)
    try:
        with engine.runtime_checks(True):
            engine.step_loop(prog, 1000, st0, [0])
        trapped = None
    except RuntimeError as err:
        trapped = str(err)
    print(f"sanitizer dead-counter write: {trapped}", flush=True)
    check(trapped is not None and "is a padded dead counter slot" in trapped,
          "sanitizer: the dead-counter write was not trapped")
    check(int(engine.step_loop(prog, 1000, st0, [0]).events[0]) > 0,
          "the dead-counter program did not run without the sanitizer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the DHT phase's keys and values and of "
                         "the serving phase's weights and prompts")
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
    if "flash_attention_wgmma" not in logs:   # cached: no ptxas report
        build.lib_path("flash_attention_wgmma").unlink()
        logs.update(build.build(("flash_attention_wgmma",)))
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}.cu ptxas: {line.strip()}", flush=True)
    log = logs["flash_attention_wgmma"]
    check("registers" in log, "no ptxas report for flash_attention_wgmma.cu")
    spills = [line.strip() for line in log.splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    check(not spills, f"flash_attention_wgmma.cu spills registers: {spills}")
    hgmma = count_sass(build.lib_path("flash_attention_wgmma"), "HGMMA")
    print(f"flash_attention_wgmma.cu SASS: {hgmma} HGMMA instructions "
          "(cuobjdump -sass)", flush=True)
    check(hgmma > 0, "the tensor-core attention kernel has no HGMMA")

    dryrun = start_dryrun()
    try:
        kernels = run_phases(args.seed, smi)
        t0 = time.perf_counter()
        dryrun_phase(dryrun)
        print(f"dryrun phase: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dryrun[0].kill()

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(seed: int, smi: str) -> list:
    """Phases 2-9 and 11; returns the kernels line's rows."""
    t0 = time.perf_counter()
    kernels = dht_phase(seed)
    print(f"dht phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kernels += serve_phase(seed)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    from_examples = fig6_phase()
    print(f"fig6 / faults / examples phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    sim_phase(from_examples)
    print(f"simulator phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    grid_phase()
    print(f"grid phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    locklint_phase()
    print(f"locklint phase: {time.perf_counter() - t0:.1f} s", flush=True)
    import shutil
    keep = []
    try:
        t0 = time.perf_counter()
        kernels += train_phase(seed, smi, keep)
        print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        kernels += hier_phase(seed, smi)
        print(f"hier phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        kernels += mesh_phase(seed, smi, keep[0] / "run")
        print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        for work in keep:
            shutil.rmtree(work, ignore_errors=True)
    return kernels


if __name__ == "__main__":
    sys.exit(main())
