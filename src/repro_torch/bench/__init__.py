"""Paper-figure benchmarks on the port: the lock benchmarks of Figs. 3
and 5 (`locks`), the threshold sweeps of Fig. 4 (`thresholds`) and the
(T_DC, T_L, T_R) auto-tuner's CLI (`tune`). Counterparts of
`benchmarks/locks.py`, `benchmarks/thresholds.py` and
`benchmarks/run.py --tune`, with the same row schema."""
