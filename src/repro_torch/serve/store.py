"""Versioned parameter store -- the paper's DC/T_DC insight transplanted
to serving (copy of `repro.serve.store`).

The paper's distributed counter shards reader bookkeeping over physical
counters (one per T_DC processes) so readers touch a nearby counter and
only the rare writer pays to visit all of them. Here decode workers are
the readers and a weight swap (new checkpoint going live) is the
writer:

  * every worker is assigned to one of C = ceil(W / T_DC) physical
    counters (arrive/depart pairs) -- readers only ever touch their own
    counter (cheap, contention-free);
  * the swapper flips every counter into WRITE mode, waits for each to
    drain (arrived == departed), installs new params, then resets the
    counters back to READ mode -- exactly Listing 6/7 of the paper, with
    the same correctness argument (§4.1 Reader & Writer).

Counter assignment is driven by the core topology mapping
(`repro_torch.core.topology.counter_of_proc`) — the same c(p) the
simulated locks and the tuner use — so a tuned `LockSpec` applies to
the serving path unchanged: `VersionedStore.from_spec(params, spec)`
realizes the spec's (P, T_DC) point as a store.

The control plane is host-side (threading) because weight swaps are a
host-driven event; the data plane (params, an `LM` module of tensors
on the card) never passes through it.

Fault tolerance mirrors the simulated locks' lease protocol: a swap is
covered by an optional `writer_lease` (seconds). If the swapper dies
mid-swap -- counters flipped to WRITE but never reset -- readers blocked
on their counter stop waiting once the lease expires, roll the WRITE
flag back on their own counter, and keep serving the last fully
installed params (`recoveries` counts these fallbacks). Params install
is a single reference assignment, so readers observe either the old or
the new checkpoint, never a torn one. As with any lease protocol, the
lease must exceed the worst-case healthy swap duration, or a slow live
swap is indistinguishable from a dead one.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.core.topology import (build_machine, counter_of_proc,
                                      counter_ranks)


class _Counter:
    __slots__ = ("arrived", "departed", "write_mode", "cv")

    def __init__(self):
        self.arrived = 0
        self.departed = 0
        self.write_mode = False
        self.cv = threading.Condition()


class VersionedStore:
    """MRSW parameter store with sharded reader counters."""

    def __init__(self, params: Any, *, n_workers: int = 8, T_DC: int = 4,
                 machine=None, writer_lease: float | None = None):
        self._params = params
        self._version = 0
        self.writer_lease = writer_lease
        self.recoveries = 0
        self._swap_started: float | None = None
        self.T_DC = max(1, T_DC)
        self.n_workers = max(1, int(n_workers))
        # c(p) from the core topology model — identical to the counter
        # placement of the simulated locks (paper §3.2.1), not a
        # re-derived ad-hoc formula.
        m = machine if machine is not None else build_machine(
            self.n_workers, ())
        self.n_counters = len(counter_ranks(m, self.T_DC))
        self._ctr_of_p = np.minimum(counter_of_proc(m, self.T_DC),
                                    self.n_counters - 1)
        self._counters: List[_Counter] = [_Counter()
                                          for _ in range(self.n_counters)]
        self._swap_lock = threading.Lock()     # one writer at a time

    @classmethod
    def from_spec(cls, params: Any, spec) -> "VersionedStore":
        """Realize a `LockSpec`'s (P, T_DC) point as a store: worker p
        maps to the counter the spec's machine model gives c(p)."""
        return cls(params, n_workers=spec.P, T_DC=spec.T_DC,
                   machine=spec.machine())

    def counter_of(self, worker_id: int) -> int:
        return int(self._ctr_of_p[worker_id % self.n_workers])

    @property
    def version(self) -> int:
        return self._version

    def _writer_lease_expired(self) -> bool:
        return (self.writer_lease is not None
                and self._swap_started is not None
                and time.monotonic() - self._swap_started
                > self.writer_lease)

    @contextmanager
    def reader_view(self, worker_id: int):
        """Acquire a read view: (params, version). Readers spin only on
        their own counter (the T_DC locality property). With a
        `writer_lease`, a reader stuck behind a swapper that died
        mid-swap rolls the WRITE flag back on its own counter once the
        lease expires and serves the last installed params."""
        c = self._counters[self.counter_of(worker_id)]
        timeout = (None if self.writer_lease is None
                   else max(self.writer_lease / 4, 1e-3))
        with c.cv:
            while c.write_mode:
                if self._writer_lease_expired():
                    c.write_mode = False
                    self.recoveries += 1
                    c.cv.notify_all()
                    break
                c.cv.wait(timeout=timeout)
            c.arrived += 1
        try:
            yield self._params, self._version
        finally:
            with c.cv:
                c.departed += 1
                c.cv.notify_all()

    def swap(self, new_params: Any) -> int:
        """Writer: block new readers on every counter, drain, install."""
        with self._swap_lock:
            self._swap_started = time.monotonic()
            for c in self._counters:           # set_counters_to_WRITE()
                with c.cv:
                    c.write_mode = True
            for c in self._counters:           # verify drained (paper §4.1)
                with c.cv:
                    while c.arrived != c.departed:
                        c.cv.wait()
            self._params = new_params
            self._version += 1
            for c in self._counters:           # reset_counters()
                with c.cv:
                    c.arrived = 0
                    c.departed = 0
                    c.write_mode = False
                    c.cv.notify_all()
            self._swap_started = None
            return self._version


class Batcher:
    """Tiny request batcher for the serving example: collects up to
    `max_batch` token requests, pads, and runs one decode step on the
    cache's device."""

    def __init__(self, decode_fn: Callable, max_batch: int):
        self.decode_fn = decode_fn
        self.max_batch = max_batch

    def run(self, requests, params, cache):
        toks = torch.zeros(self.max_batch, 1, dtype=torch.int32)
        reqs = list(requests[: self.max_batch])
        toks[: len(reqs), 0] = torch.tensor(reqs, dtype=torch.int32)
        return self.decode_fn(params, toks.to(cache["len"].device), cache)
