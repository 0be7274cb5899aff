"""Runnable examples of the port, counterparts of the reference's
`examples/`: `quickstart` (the RMA-RW lock and the DHT it accelerates),
`lock_demo` (every protocol, the T_L and T_R dials and the 3D grid) and
`serve_kv` (batched decode under the versioned store with the DHT as
request-metadata store). Run as `python -m repro_torch.examples.<name>
[--device cpu]`; each `main(device=...)` returns what it printed."""
