"""PyTorch port of `repro`, the distributed RMA lock simulator and its
§5.3 DHT volume, with hand-written CUDA kernels for NVIDIA Hopper.

Entry points run on CUDA unless given `device="cpu"`:
`repro_torch.core.Session` and `repro_torch.dht.BatchedDHT`.
"""
