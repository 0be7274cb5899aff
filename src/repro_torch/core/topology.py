"""Machine topology model for the distributed RMA lock simulator.

The paper (Schmid, Besta, Hoefler: "High-Performance Distributed RMA
Locks") assumes an N-level machine hierarchy (e.g. machine > rack >
node). Level 1 is the root (whole machine), level N is the leaf level
(compute nodes). `e(p, i)` maps a process to its element at level i and
`c(p)` maps a reader to its physical counter (parameter T_DC).

Everything here is static (precomputed numpy arrays, copied to the
simulator's device once per environment), so one event step of the
simulator is a fixed sequence of tensor ops over all lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Machine:
    """An N-level machine hierarchy.

    Attributes:
      P: number of processes.
      N: number of levels (level 1 = root = whole machine, level N = leaf).
      n_elems: number of elements per level, shape [N] (n_elems[0] == 1).
      proc_elem: element id of process p at level i; int array [N, P].
        proc_elem[0] == 0 for all p (single root element).
      elem_host: hosting rank for each element's static lock words;
        list of int arrays, elem_host[i][j] = rank hosting element j of
        level i+1's... indexed [N][n_elems[i]].
    """

    P: int
    N: int
    n_elems: np.ndarray          # [N]
    proc_elem: np.ndarray        # [N, P]
    elem_host: tuple             # len N, each [n_elems[i]]

    @property
    def leaf_elems(self) -> int:
        return int(self.n_elems[self.N - 1])


def build_machine(P: int, fanout: Sequence[int]) -> Machine:
    """Build a balanced machine.

    Args:
      P: process count.
      fanout: children per element for levels 1..N-1, e.g. for
        N=3 (machine > racks > nodes) fanout=(n_racks, nodes_per_rack).
        Processes are distributed evenly over the leaf elements, in rank
        order (the paper's "x successive ranks per node" layout).

    Returns a Machine with N = len(fanout) + 1 levels.
    """
    N = len(fanout) + 1
    n_elems = [1]
    for f in fanout:
        n_elems.append(n_elems[-1] * int(f))
    n_elems = np.asarray(n_elems, dtype=np.int32)
    leafs = int(n_elems[N - 1])
    if P % leafs != 0:
        raise ValueError(f"P={P} not divisible by leaf element count {leafs}")
    per_leaf = P // leafs

    proc_elem = np.zeros((N, P), dtype=np.int32)
    leaf_of_p = np.arange(P, dtype=np.int32) // per_leaf
    proc_elem[N - 1] = leaf_of_p
    # Ancestors: element j at level i+1 has parent j // fanout[i] at level i.
    for i in range(N - 2, -1, -1):
        # children per element at level i+1 grouped evenly into level i.
        ratio = int(n_elems[i + 1] // n_elems[i])
        proc_elem[i] = proc_elem[i + 1] // ratio

    # Host of element j at level i: lowest rank inside it.
    elem_host = []
    for i in range(N):
        hosts = np.zeros(int(n_elems[i]), dtype=np.int32)
        for j in range(int(n_elems[i])):
            hosts[j] = int(np.argmax(proc_elem[i] == j))
        elem_host.append(hosts)
    return Machine(P=P, N=N, n_elems=n_elems, proc_elem=proc_elem,
                   elem_host=tuple(elem_host))


def counter_ranks(m: Machine, T_DC: int) -> np.ndarray:
    """Ranks that host a physical counter: every T_DC-th process.

    The paper's hardware-oblivious default c(p) = ceil(p / T_DC); with the
    block process layout produced by `build_machine` this places one
    counter on every (T_DC / procs_per_node)-th node, matching the
    topology-aware placement discussed in §3.2.1.
    """
    if T_DC < 1:
        raise ValueError("T_DC must be >= 1")
    return np.arange(0, m.P, T_DC, dtype=np.int32)


def counter_of_proc(m: Machine, T_DC: int) -> np.ndarray:
    """c(p): index (into counter_ranks) of the physical counter of p."""
    return (np.arange(m.P, dtype=np.int32) // T_DC)


def proc_distance_matrix(m: Machine) -> np.ndarray:
    """Hierarchy distance between every pair of ranks.

    0 = same process, 1 = same leaf element (node) but different process,
    2 = different node under a common level-(N-1) ancestor (e.g. same
    rack), 3 = crosses a rack, ... Shape [P, P], int32.
    """
    P = m.P
    d = np.zeros((P, P), dtype=np.int32)
    for lvl in range(m.N - 1, -1, -1):
        same = m.proc_elem[lvl][:, None] == m.proc_elem[lvl][None, :]
        # Differing at 0-based level lvl => distance (N - lvl) + 1.
        d = np.where(same, d, m.N - lvl + 1)
    np.fill_diagonal(d, 0)
    # Same leaf but different process -> distance 1.
    same_leaf = m.proc_elem[m.N - 1][:, None] == m.proc_elem[m.N - 1][None, :]
    off_diag = ~np.eye(P, dtype=bool)
    d = np.where(same_leaf & off_diag & (d == 0), 1, d)
    return d
