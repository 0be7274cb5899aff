"""PyTorch port of `repro`: the distributed RMA lock simulator, its
§5.3 DHT volume and the serving and single-device training paths of the
LM substrate (every model family), with hand-written CUDA kernels for
NVIDIA Hopper.

Entry points run on CUDA unless given `device="cpu"`:
`repro_torch.core.Session`, `repro_torch.dht.BatchedDHT`,
`repro_torch.models.lm.init_params` / `make_cache`,
`repro_torch.models.convert.from_reference` / `state_from_reference`,
`repro_torch.train.init_state`, `repro_torch.runtime.Trainer`,
`python -m repro_torch.launch.serve`,
`python -m repro_torch.launch.train` and
`python -m repro_torch.launch.smoke_models`.
"""
