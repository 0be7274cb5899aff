from repro_torch.data.synthetic import batch_for

__all__ = ["batch_for"]
