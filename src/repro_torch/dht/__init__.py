"""The paper's §5.3 DHT local volume (table + overflow heap) in PyTorch."""
from repro_torch.dht.table import BatchedDHT, DHTState

__all__ = ["BatchedDHT", "DHTState"]
