"""Slot-based KV / state cache for continuous batching (counterpart of
``repro.serve.cache``).

The cache is the family's own ``init_cache(slots, max_seq)`` dict, every
leaf with the slot axis at position 1: the dense family carries ``(L,
slots, max_seq, Hkv, D)`` KV buffers, the stateful family (RWKV-6) ``(L,
slots, H, D, D)`` WKV state plus ``(L, slots, 1, d)`` token-shift carries.
Shapes never change as requests come and go: admission copies a freshly
prefilled sub-cache into free slot rows in place, eviction returns the
slot id to the free list (the row's stale contents are dead: the next
admission overwrites the whole row).

Host-side bookkeeping: ``cursors``, the per-slot write cursor (absolute
cache position of the next token), passed as the vector ``cache_len`` of
decode; and the free list, lowest slot first, so a replayed trace admits
into the same slots.  A slot holds ``max_seq`` positions, and admission
needs ``prompt_len + max_new <= max_seq``.
"""
from __future__ import annotations

import numpy as np
import torch


class SlotKVCache:
    """Fixed-shape slot cache + free-slot map + per-slot write cursors."""

    def __init__(self, ops, slots: int, max_seq: int):
        self.slots = slots
        self.max_seq = max_seq
        self.tree = ops.init_cache(slots, max_seq)
        #: stateful families (rwkv) have no per-position axis to overflow
        self.stateful = "wkv" in self.tree
        self.cursors = np.zeros(slots, np.int32)
        self._free = sorted(range(slots), reverse=True)  # pop() -> lowest id

    # -- allocation ---------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list:
        if n > len(self._free):
            raise RuntimeError(
                f"requested {n} slots but only {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, slot: int) -> None:
        self.cursors[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)

    # -- capacity -----------------------------------------------------------
    def validate_admit(self, prompt_len: int, max_new: int) -> None:
        """Reject a request that cannot fit: prompt + generated tokens must
        stay inside the slot's ``max_seq`` positions (KV families)."""
        if self.stateful:
            return
        need = prompt_len + max_new
        if need > self.max_seq:
            raise ValueError(
                f"request needs {need} cache positions (prompt={prompt_len} "
                f"+ max_new={max_new}) but slots hold max_seq={self.max_seq}; "
                f"raise ServeEngine(max_seq=...) or shorten the request")

    # -- adoption -----------------------------------------------------------
    def adopt(self, sub_tree, slot_ids, lengths) -> None:
        """Copy a prefilled sub-cache (slot axis 1, rows parallel to
        ``slot_ids``) into the slot cache in place and start the write
        cursors at each row's true prompt length."""
        for key, buf in self.tree.items():
            ids = torch.as_tensor(np.asarray(slot_ids, np.int64),
                                  device=buf.device)
            buf.index_copy_(1, ids, sub_tree[key].to(buf.dtype))
        for s, ln in zip(slot_ids, np.asarray(lengths)):
            self.cursors[s] = int(ln)

    def zeros_like_sub(self, ops, n_rows: int):
        """A fresh all-zero sub-cache for ``n_rows`` prefill rows."""
        return ops.init_cache(n_rows, self.max_seq)
