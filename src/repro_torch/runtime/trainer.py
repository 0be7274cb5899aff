"""Fault-tolerant training runner (counterpart of
`repro.runtime.trainer`).

  * the train step runs eagerly on one device (CUDA unless given
    another), or on a mesh (`mesh=`, a `DeviceMesh` of the current
    process group, every rank running this loop): the state placed by
    `shardings` (a (mesh, placements) tree) or else by
    `parallel.sharding.state_placements` on `mesh`, at init and at
    restore, each batch by `parallel.sharding.batch_specs`; only global
    rank 0 writes `metrics.jsonl`, and checkpoints keep the one-device
    format (a run saved on one device resumes on a mesh and the other
    way round);
  * deterministic data via data.synthetic keyed by the global step, so
    restarts replay the exact stream, the same on every rank (the
    prefetch thread also copies each batch to the device);
  * periodic async checkpointing off the critical path;
  * crash/restart: `run()` resumes from the latest checkpoint in
    workdir; `run_with_recovery()` relaunches it on failure under a
    restart budget with capped exponential backoff;
  * fault injection hook for the tests (`fault_at_step`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, place_state)
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding, spmd
from repro_torch.train.step import TrainState, build_train_step, init_state


@dataclasses.dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    log_every: int = 10
    remat: str = "none"
    seed: int = 0
    fault_at_step: Optional[int] = None       # raise once at this step
    warmup_steps: int = 100
    total_steps: int = 10_000
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg, workdir: str, tc: TrainerConfig = TrainerConfig(),
                 mesh=None, shardings=None, device=None):
        self.cfg, self.workdir, self.tc = cfg, workdir, tc
        if shardings is not None and mesh is None:
            mesh = next(iter(shardings.params.values()))[0]
        self.mesh, self.shardings = mesh, shardings
        if mesh is not None and device is None:
            device = mesh.device_type
        self.device = resolve_device(device)
        os.makedirs(workdir, exist_ok=True)
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self._step_fn = build_train_step(
            cfg, tc.opt, remat=tc.remat, warmup_steps=tc.warmup_steps,
            total_steps=tc.total_steps)
        self._faulted = False

    # -- state ----------------------------------------------------------
    def _placements(self, state):
        """The state's (mesh, placements) tree, or None off a mesh."""
        if self.mesh is None:
            return None
        return self.shardings or sharding.state_placements(state, self.mesh)

    def _init_or_restore(self) -> TrainState:
        last = latest_step(self.ckpt_dir)
        if last is not None and self.mesh is not None:
            # Restored leaf by leaf onto the mesh: the like is shapes only.
            like = init_state(self.cfg, None, "meta")
            state, _ = load_checkpoint(self.ckpt_dir, last, like,
                                       sharding_tree=self._placements(like))
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tc.seed)
            state = init_state(self.cfg, gen, self.device)
            if last is not None:
                state, _ = load_checkpoint(self.ckpt_dir, last, state)
            elif self.mesh is not None:
                state = place_state(state, self._placements(state))
        if last is not None:
            print(f"[trainer] restored step {last} from {self.ckpt_dir}")
        return state

    def _log(self, step: int, metrics: dict, dt: float):
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return
        rec = {"step": step, "dt_s": round(dt, 4)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _to_device(self, batch: dict) -> dict:
        out = {k: torch.from_numpy(v).to(self.device)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        from torch.distributed.tensor import distribute_tensor
        specs = sharding.batch_specs(out, self.mesh)
        return {k: distribute_tensor(
            v, self.mesh, sharding._placements(specs[k], self.mesh, k),
            src_data_rank=None) for k, v in out.items()}

    # -- main loop --------------------------------------------------------
    def run(self, num_steps: int) -> TrainState:
        state = self._init_or_restore()
        start = int(spmd.to_local(state.step))
        ckpt = AsyncCheckpointer(self.ckpt_dir)
        data = SyntheticLM(self.cfg, self.tc.batch, self.tc.seq,
                           seed=self.tc.seed, start_step=start,
                           device_put_fn=self._to_device)
        try:
            for step, batch in data:
                if step >= num_steps:
                    break
                if (self.tc.fault_at_step is not None
                        and step == self.tc.fault_at_step
                        and not self._faulted):
                    self._faulted = True
                    raise RuntimeError(
                        f"injected fault at step {step}")
                t0 = time.perf_counter()
                state, metrics = self._step_fn(state, batch)
                if step % self.tc.log_every == 0:
                    _sync(self.device)
                    self._log(step, metrics, time.perf_counter() - t0)
                if (step + 1) % self.tc.ckpt_every == 0:
                    ckpt.submit(step + 1, state)
            ckpt.submit(int(spmd.to_local(state.step)), state)
        finally:
            data.close()
            ckpt.close()
        return state

    def run_with_recovery(self, num_steps: int, max_restarts: int = 3, *,
                          backoff_s: float = 0.5, backoff_factor: float = 2.0,
                          max_backoff_s: float = 30.0,
                          sleep=time.sleep) -> TrainState:
        """Catch step failures, restore the latest checkpoint, continue --
        the single-process analogue of a cluster relaunch policy.

        Restarts are budgeted: at most `max_restarts` relaunches, spaced
        by exponential backoff (`backoff_s * backoff_factor**i`, capped
        at `max_backoff_s`) so a persistently failing job does not
        hot-loop. `sleep` is injectable so tests can record the delays
        instead of waiting them out. Exhausting the budget re-raises
        with the last failure chained."""
        last_err = None
        for attempt in range(max_restarts + 1):
            if attempt:
                delay = min(backoff_s * backoff_factor ** (attempt - 1),
                            max_backoff_s)
                print(f"[trainer] failure ({last_err}); restart "
                      f"{attempt}/{max_restarts} in {delay:.2g}s")
                sleep(delay)
            try:
                return self.run(num_steps)
            except RuntimeError as e:
                last_err = e
        raise RuntimeError(
            f"max restarts ({max_restarts}) exceeded") from last_err
