"""Device-resident LRU cache of rerank-candidate multivectors, PyTorch
port of `morphik_core_tpu/index/device_cache.py`.

A fixed pool of (token_bucket, dim) slots lives on the device next to
the FDE index. A query's candidate rows that are resident are scored
where they lie: the MaxSim kernel takes the slot ids as its row-index
vector (K1 for int8 slots, K2 for bf16 slots), so a warm query gathers
nothing and uploads nothing. Misses are written into their slots in
place (replacing the reference's donated-buffer scatter), and that write
doubles as the upload. Eviction is host-side LRU over slot ids; rows
longer than the slot bucket bypass the cache (the caller takes the
direct path).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from morphik_core_tpu_torch.ops.maxsim import maxsim, maxsim_q8, quantize_query_q8
from morphik_core_tpu_torch.parallel.search import quantize_rows_int8


class DevicePoolCache:
    def __init__(self, slots: int, token_bucket: int, dim: int, device,
                 dtype=torch.bfloat16, quantized: bool = False):
        """`quantized=True` stores slots as per-token int8 + f32 scale
        (half the memory of bf16 and the int8 kernel)."""
        self.slots = int(slots)
        self.token_bucket = int(token_bucket)
        if quantized and self.token_bucket % 8:
            raise ValueError(
                f"quantized cache needs token_bucket % 8 == 0, got {token_bucket}"
            )
        self.dim = int(dim)
        self.device = torch.device(device)
        self.quantized = bool(quantized)
        slot_dtype = torch.int8 if quantized else dtype
        shape = (self.slots, self.token_bucket)
        self._buf = torch.zeros(shape + (self.dim,), dtype=slot_dtype, device=self.device)
        self._sbuf = torch.ones(shape, dtype=torch.float32, device=self.device) if quantized else None
        self._mbuf = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._row_to_slot: "OrderedDict[int, int]" = OrderedDict()  # LRU: oldest first
        self._slot_to_row: Dict[int, int] = {}
        self._free: List[int] = list(range(self.slots))
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- state

    def resident(self, rows: Sequence[int]) -> bool:
        return all(r in self._row_to_slot for r in rows)

    def invalidate(self, row: int) -> None:
        slot = self._row_to_slot.pop(row, None)
        if slot is not None:
            self._slot_to_row.pop(slot, None)
            self._free.append(slot)

    def invalidate_all(self) -> None:
        self._row_to_slot.clear()
        self._slot_to_row.clear()
        self._free = list(range(self.slots))

    def _alloc(self, n: int, protected: frozenset) -> List[int]:
        """Free or evict `n` slots, never evicting `protected` rows (the
        current query's pool)."""
        out = []
        while len(out) < n:
            if self._free:
                out.append(self._free.pop())
                continue
            row, slot = next(iter(self._row_to_slot.items()))  # LRU first
            if row in protected:
                self._row_to_slot.move_to_end(row)
                continue
            del self._row_to_slot[row]
            self._slot_to_row.pop(slot, None)
            out.append(slot)
        return out

    def _insert(self, misses: List[int], fetch_row, protected: frozenset) -> None:
        n = len(misses)
        masks = np.zeros((n, self.token_bucket), np.float32)
        dense = np.zeros((n, self.token_bucket, self.dim), np.float32)
        for j, r in enumerate(misses):
            mv = np.asarray(fetch_row(r), dtype=np.float32)
            dense[j, : mv.shape[0]] = mv
            masks[j, : mv.shape[0]] = 1.0
        slots = self._alloc(n, protected)
        slot_t = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        if self.quantized:
            q8, sc = quantize_rows_int8(dense)  # one batched pass
            self._buf[slot_t] = torch.from_numpy(q8).to(self.device)
            self._sbuf[slot_t] = torch.from_numpy(sc).to(self.device)
        else:
            # 16-bit upload, then f16 -> bf16 on the device, as the
            # reference's insert casts to the buffer dtype
            self._buf[slot_t] = torch.from_numpy(dense.astype(np.float16)).to(self.device).to(self._buf.dtype)
        self._mbuf[slot_t] = torch.from_numpy(masks).to(self.device)
        for r, s in zip(misses, slots):
            self._row_to_slot[r] = s
            self._slot_to_row[s] = r

    # ------------------------------------------------------------- query

    def score(self, pool_rows: Sequence[int], q: np.ndarray, fetch_row, n_tokens,
              use_kernel: bool = True) -> Optional[np.ndarray]:
        """Exact MaxSim scores for `pool_rows` (in order), insert-on-miss.
        Returns None when any row exceeds the slot bucket. `use_kernel=False`
        scores with the kernels' plain versions."""
        if any(n_tokens(r) > self.token_bucket for r in pool_rows):
            return None
        misses = [r for r in pool_rows if r not in self._row_to_slot]
        if misses:
            self._insert(misses, fetch_row, frozenset(pool_rows))
        self.hits += len(pool_rows) - len(misses)
        self.misses += len(misses)
        gather = []
        for r in pool_rows:  # LRU touch in query order
            self._row_to_slot.move_to_end(r)
            gather.append(self._row_to_slot[r])
        idx = torch.as_tensor(gather, dtype=torch.int32, device=self.device)
        if self.quantized:
            q8, qs = quantize_query_q8(q)  # same recipe as the cold path
            scores = maxsim_q8(
                torch.from_numpy(q8).to(self.device), torch.from_numpy(qs).to(self.device),
                self._buf, self._sbuf, self._mbuf, idx, use_kernel=use_kernel,
            )
        else:
            qf = torch.tensor(np.asarray(q, dtype=np.float32), device=self.device)
            scores = maxsim(qf, self._buf, self._mbuf, idx, use_kernel=use_kernel)
        return scores.cpu().numpy()
