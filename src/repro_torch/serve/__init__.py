from repro_torch.serve.steps import (build_decode_step, build_prefill_step,
                                     cache_shapes)
from repro_torch.serve.store import Batcher, VersionedStore

__all__ = ["Batcher", "build_decode_step", "build_prefill_step",
           "cache_shapes", "VersionedStore"]
