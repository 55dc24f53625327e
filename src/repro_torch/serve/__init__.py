"""Continuous-batching inference service of the port (counterpart of
``repro.serve``).

Slot-based KV cache + admission/eviction scheduler on top of the
``ModelOps`` decode/prefill of the dense LM.  See ``cache.SlotKVCache`` and
``engine.ServeEngine``.
"""
from repro_torch.serve.cache import SlotKVCache
from repro_torch.serve.engine import (Finished, Request, RequestFeed,
                                      ServeEngine, poisson_trace)

__all__ = ["SlotKVCache", "Request", "Finished", "ServeEngine",
           "RequestFeed", "poisson_trace"]
