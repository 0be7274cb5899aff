"""locklint on the port: static analysis and small-P model checking of
the lock programs (counterpart of `repro.analysis`).

  * `repro_torch.analysis.trace` — replay of instruction handlers, lanes
    at a time, recording each handler's window and register footprint
    (`engine.RecordingCtx`) and its declared `Effect`.
  * `repro_torch.analysis.ir` — per-instruction IR (footprints, declared
    effects, CFG edges) extracted from recorded replays.
  * `repro_torch.analysis.model` — exhaustive small-P model checker over
    the canonical (timing-free) state space, one engine call per
    breadth-first level: mutual exclusion, reader/writer exclusion,
    deadlock/livelock freedom.
  * `repro_torch.analysis.lints` — layout, bounds, structure and
    lost-wakeup lints over layouts and extracted IR.
  * `repro_torch.analysis.locklint` — the CLI driving all passes
    (`python -m repro_torch.analysis.locklint --all [--device cpu]`).

The runtime counterpart is the opt-in sanitizer in
`repro_torch.core.engine` (`REPRO_CHECKS=1` or
`engine.runtime_checks(True)`).
"""
from repro_torch.analysis.lints import Finding  # noqa: F401
from repro_torch.analysis.model import Explorer  # noqa: F401
