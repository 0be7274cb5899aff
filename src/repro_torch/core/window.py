"""RMA window layout for the lock protocols.

One flat int32 array models the union of all processes' exposed windows
(the paper groups all locking structures into MPI-allocated windows,
§5 "Implementation Details"). A static layout table maps protocol
variables to word indices, and `owner` records which rank physically
hosts each word — the cost model charges origin->owner distance for
every RMA op.

Queue entries at level i < N are *element nodes* (one per element at
level i+1), hosted on that element's host rank; at the leaf level N the
entries are processes. This is the HMCS-style completion of the paper's
abbreviated listings (see DESIGN.md §2): any current representative
process of an element operates on the element's node when acquiring or
releasing the parent level, which is what makes intra-element lock
handoff compose with the upper levels.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Machine, counter_of_proc, counter_ranks

NULL = np.int32(-1)            # the paper's "∅"
WAIT = np.int32(-2)            # STATUS: spin
ACQUIRE_PARENT = np.int32(-3)  # STATUS: must acquire the lock at level i-1
MODE_CHANGE = np.int32(-4)     # STATUS: lock was handed to the readers
ACQUIRE_START = np.int32(0)    # STATUS: base value of the pass counter
WRITE_FLAG = np.int32(1 << 28) # ARRIVE bit: CS is in WRITE mode (paper: INT64_MAX/2)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Word-index layout of the single flat RMA window."""

    W: int                       # total number of words
    owner: np.ndarray            # [W] hosting rank of each word
    # Queues: per level i (0-based: 0 = root .. N-1 = leaf), per entity.
    next_w: tuple                # len N, [n_entities_i] word of NEXT
    status_w: tuple              # len N, [n_entities_i] word of STATUS
    tail_w: tuple                # len N, [n_elems_i]    word of TAIL
    n_entities: np.ndarray       # [N]
    # Distributed counter (DC), per physical counter slot. Slots may be
    # padded past the C real counters (`pad_counters_to`) so layouts for
    # different T_DC share one shape; `ctr_mask` marks the real slots.
    arrive_w: np.ndarray         # [C_pad]
    depart_w: np.ndarray         # [C_pad]
    C: int                       # number of REAL physical counters
    ctr_rank: np.ndarray         # [C_pad] hosting rank of counter c
    ctr_mask: np.ndarray         # [C_pad] bool; False = padded slot
    ctr_of_p: np.ndarray         # [P] counter index c(p), always < C
    # Scratch region (baselines, DHT, CS payloads) — always the LAST
    # `extra_words` words. Programs must address scratch through this
    # table (via Env), never through baked absolute indices: W varies
    # with counter padding, scratch slots do not.
    scratch_w: np.ndarray        # [extra_words]
    # Entity helpers.
    ent_of_p: np.ndarray         # [N, P] entity id that p acts as at level i
    elem_of_p: np.ndarray        # [N, P] element id of p at level i (= e(p,i))
    init: np.ndarray             # [W] initial window contents


def build_layout(m: Machine, T_DC: int = 1, extra_words: int = 0,
                 pad_counters_to: int | None = None) -> Layout:
    """Assign word indices for an N-level lock over machine `m`.

    Level indexing here is 0-based with 0 = root (paper's level 1) and
    N-1 = leaf (paper's level N).

    `pad_counters_to` pads the counter tables (and the window itself)
    with dead masked slots up to the given slot count, so every T_DC of
    one machine yields bitwise-identical array SHAPES — the property
    that lets `Session.grid`/`sweep("T_DC", ...)` trace the whole T_DC
    axis once. Padded slots are never addressed by the protocols
    (`ctr_of_p < C` and the counter loops stop at the masked boundary),
    so the simulated dynamics are unchanged.
    """
    N, P = m.N, m.P
    words = []  # (owner_rank, init_value)

    def alloc(owner: int, init: int = int(NULL)) -> int:
        words.append((int(owner), int(init)))
        return len(words) - 1

    next_w, status_w, tail_w, n_entities = [], [], [], []
    for i in range(N):
        if i == N - 1:
            ents = P
            hosts = np.arange(P, dtype=np.int32)
        else:
            ents = int(m.n_elems[i + 1])
            hosts = m.elem_host[i + 1]
        n_entities.append(ents)
        next_w.append(np.asarray([alloc(hosts[e]) for e in range(ents)], np.int32))
        status_w.append(np.asarray([alloc(hosts[e], int(WAIT)) for e in range(ents)], np.int32))
        tails = m.elem_host[i]
        tail_w.append(np.asarray(
            [alloc(tails[j]) for j in range(int(m.n_elems[i]))], np.int32))

    c_ranks = counter_ranks(m, T_DC)
    C = len(c_ranks)
    C_pad = C if pad_counters_to is None else int(pad_counters_to)
    if C_pad < C:
        raise ValueError(
            f"pad_counters_to={C_pad} < {C} real counters (T_DC={T_DC})")
    pad_ranks = [int(c_ranks[-1])] * (C_pad - C)
    arrive_w = np.asarray([alloc(r, 0) for r in c_ranks]
                          + [alloc(r, 0) for r in pad_ranks], np.int32)
    depart_w = np.asarray([alloc(r, 0) for r in c_ranks]
                          + [alloc(r, 0) for r in pad_ranks], np.int32)
    ctr_mask = np.arange(C_pad) < C
    ctr_of_p = np.minimum(counter_of_proc(m, T_DC), C - 1)

    scratch_w = np.asarray(       # scratch (baselines, DHT, CS payloads)
        [alloc(k % P, 0) for k in range(extra_words)], np.int32)

    ent_of_p = np.zeros((N, P), dtype=np.int32)
    for i in range(N):
        if i == N - 1:
            ent_of_p[i] = np.arange(P, dtype=np.int32)
        else:
            ent_of_p[i] = m.proc_elem[i + 1]

    owner = np.asarray([w[0] for w in words], np.int32)
    init = np.asarray([w[1] for w in words], np.int32)
    return Layout(
        W=len(words), owner=owner,
        next_w=tuple(next_w), status_w=tuple(status_w), tail_w=tuple(tail_w),
        n_entities=np.asarray(n_entities, np.int32),
        arrive_w=arrive_w, depart_w=depart_w, C=C,
        ctr_rank=np.asarray(list(c_ranks) + pad_ranks, np.int32),
        ctr_mask=ctr_mask, ctr_of_p=ctr_of_p, scratch_w=scratch_w,
        ent_of_p=ent_of_p, elem_of_p=m.proc_elem.copy(), init=init)


def padded_level_table(layout: Layout, attr: str, fill: int = -1) -> np.ndarray:
    """Stack per-level word tables into one rectangular [N, max_entities]
    array so the jitted simulator can index words as table[level, entity]."""
    tabs = getattr(layout, attr)
    width = max(len(t) for t in tabs)
    out = np.full((len(tabs), width), fill, dtype=np.int32)
    for i, t in enumerate(tabs):
        out[i, : len(t)] = t
    return out
