"""PyTorch port of `repro`: the distributed RMA lock simulator, its
§5.3 DHT volume and the serving path of the LM substrate (every model
family), with hand-written CUDA kernels for NVIDIA Hopper.

Entry points run on CUDA unless given `device="cpu"`:
`repro_torch.core.Session`, `repro_torch.dht.BatchedDHT`,
`repro_torch.models.lm.init_params` / `make_cache`,
`repro_torch.models.convert.from_reference`,
`python -m repro_torch.launch.serve` and
`python -m repro_torch.launch.smoke_models`.
"""
