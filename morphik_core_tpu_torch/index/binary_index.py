"""Binary-quantized multivector index: PyTorch port of
`morphik_core_tpu/index/binary_index.py:28-179` (the reference's
"postgres provider" parity path). Every token is quantized to its sign
bits (MSB-first, dim/8 bytes), and a query is the EXACT binary MaxSim
over all authorized rows: K4 (`csrc/binary_maxsim.cu`) on the card.

  - Packed bits live in host RAM as (capacity, token_bucket, dim/8) u8.
  - Up to `device_budget_bytes` of `bits[:count]` stay resident on the
    index's device with each row's token count; the resident copy only
    grows (rows are append-only; a delete or upsert tombstones on the
    host), so a store uploads only its new rows. Past the budget, the scan
    streams blocks of `block_rows` allowed rows from the host.
  - Filters and tombstones are applied on the host, and the ranking is the
    reference's `np.argsort(-scores)` over the same f32 array: binary
    scores tie often (multiples of 1/dim), and another sort would order the
    ties differently.
  - `save()` is a no-op, as in the reference: the index keeps no files.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.index.multivector_index import IndexRecord, _round_capacity
from morphik_core_tpu_torch.ops.binary import binary_maxsim, binary_quantize_packed

logger = logging.getLogger(__name__)


class BinaryMultiVectorIndex:
    def __init__(
        self,
        dim: int = 128,
        token_bucket: int = 1024,
        block_rows: int = 4096,
        device_budget_bytes: int = 4 * 1024**3,
        device=None,
    ):
        self.dim = dim
        self.token_bucket = token_bucket
        self.block_rows = block_rows
        self.device_budget_bytes = device_budget_bytes
        self.device = torch.device(device) if device is not None else default_device()
        self._lock = threading.RLock()
        self.records: List[IndexRecord] = []
        self._id_to_row: Dict[str, int] = {}
        self._doc_rows: Dict[str, List[int]] = {}
        self._capacity = 0
        self._count = 0
        self._bits: Optional[np.ndarray] = None  # (cap, bucket, dim//8) uint8
        self._ntok: Optional[np.ndarray] = None  # (cap,) int32
        self._alive = np.zeros(0, dtype=bool)
        self._device_bits: Optional[torch.Tensor] = None  # bits[:_device_count] on the device
        self._device_ntok: Optional[torch.Tensor] = None  # (rows,) int32
        self._device_count = 0  # rows covered by the device copy

    def __len__(self) -> int:
        return int(self._alive[: self._count].sum()) if self._count else 0

    def _grow(self, need: int) -> None:
        cap = _round_capacity(need)
        bits = np.zeros((cap, self.token_bucket, self.dim // 8), dtype=np.uint8)
        ntok = np.zeros(cap, dtype=np.int32)
        alive = np.zeros(cap, dtype=bool)
        if self._count:
            bits[: self._count] = self._bits[: self._count]
            ntok[: self._count] = self._ntok[: self._count]
            alive[: self._count] = self._alive[: self._count]
        self._bits, self._ntok, self._alive, self._capacity = bits, ntok, alive, cap

    def store(self, multivectors: Sequence[np.ndarray], records: Sequence[IndexRecord]) -> List[str]:
        ids = []
        with self._lock:
            if self._count + len(records) > self._capacity:
                self._grow(self._count + len(records))
            for mv, rec in zip(multivectors, records):
                mv = np.asarray(mv, dtype=np.float32)[: self.token_bucket]
                packed = binary_quantize_packed(mv)
                sid = f"{rec.document_id}-{rec.chunk_number}"
                old = self._id_to_row.get(sid)
                if old is not None:
                    self._alive[old] = False
                row = self._count
                rec.n_tokens = mv.shape[0]
                self.records.append(rec)
                self._bits[row, : packed.shape[0]] = packed
                self._ntok[row] = packed.shape[0]
                self._alive[row] = True
                self._id_to_row[sid] = row
                self._doc_rows.setdefault(rec.document_id, []).append(row)
                self._count += 1
                ids.append(sid)
        return ids

    def delete_document(self, document_id: str) -> int:
        with self._lock:
            rows = self._doc_rows.pop(document_id, [])
            n = 0
            for r in rows:
                if self._alive[r]:
                    self._alive[r] = False
                    n += 1
                self._id_to_row.pop(f"{document_id}-{self.records[r].chunk_number}", None)
            return n

    def get_chunks_by_id(self, chunk_ids: Sequence[Tuple[str, int]]) -> List[Optional[IndexRecord]]:
        out = []
        for doc_id, chunk_no in chunk_ids:
            row = self._id_to_row.get(f"{doc_id}-{chunk_no}")
            out.append(self.records[row] if row is not None and self._alive[row] else None)
        return out

    def save(self) -> None:
        """A no-op, as in the reference: the binary index keeps no files
        (it is rebuilt from the multivectors)."""
        logger.debug("binary index save() is a no-op (rebuilt from multivector payloads)")

    def _scores(self, q: torch.Tensor, bits: torch.Tensor, ntok: torch.Tensor) -> np.ndarray:
        return binary_maxsim(q, bits, ntok, self.dim).cpu().numpy()

    def query(
        self,
        query_embedding: np.ndarray,
        k: int,
        doc_ids: Optional[Sequence[str]] = None,
        return_timing: bool = False,
    ) -> List[Tuple[IndexRecord, float]]:
        """Exact binary MaxSim over all (authorized) rows: one K4 launch over
        the resident rows, or one per streamed block of allowed rows."""
        if self._count == 0 or k <= 0:
            return []
        q_packed = binary_quantize_packed(np.asarray(query_embedding, np.float32))
        mask_rows = self._alive[: self._count].copy()
        if doc_ids is not None:
            allowed = np.zeros(self._count, dtype=bool)
            for d in doc_ids:
                for r in self._doc_rows.get(d, []):
                    if r < self._count:
                        allowed[r] = True
            mask_rows &= allowed
        if not mask_rows.any():
            return []

        qt = torch.from_numpy(q_packed).to(self.device)
        scores = np.full(self._count, -np.inf, dtype=np.float32)

        resident = self._ensure_device_cache()
        if resident:
            # one device scan over ALL resident rows; row filter applied host-side
            all_scores = self._scores(qt, self._device_bits, self._device_ntok)
            covered = min(self._device_count, self._count)
            sel = mask_rows[:covered]
            scores[:covered][sel] = all_scores[:covered][sel]
            start_stream = covered
        else:
            start_stream = 0
        idx_all = np.nonzero(mask_rows)[0]
        idx_all = idx_all[idx_all >= start_stream]
        for s in range(0, len(idx_all), self.block_rows):
            rows = idx_all[s : s + self.block_rows]
            bits = torch.from_numpy(self._bits[rows]).to(self.device)
            ntok = torch.from_numpy(self._ntok[rows]).to(self.device)
            scores[rows] = self._scores(qt, bits, ntok)
        top = np.argsort(-scores)[: min(k, int(mask_rows.sum()))]
        return [(self.records[int(i)], float(scores[int(i)])) for i in top if np.isfinite(scores[int(i)])]

    def _ensure_device_cache(self) -> bool:
        """Keep bits[:count] resident on the device under the byte budget.
        The copy only grows: rows past the covered ones are uploaded and
        appended to it."""
        nbytes = self._count * self.token_bucket * (self.dim // 8)
        if self._count == 0 or nbytes > self.device_budget_bytes:
            return False
        if self._device_count != self._count:
            lo = self._device_count
            new_bits = torch.from_numpy(self._bits[lo : self._count]).to(self.device)
            new_ntok = torch.from_numpy(self._ntok[lo : self._count]).to(self.device)
            if lo:
                new_bits = torch.cat([self._device_bits, new_bits])
                new_ntok = torch.cat([self._device_ntok, new_ntok])
            self._device_bits, self._device_ntok = new_bits, new_ntok
            self._device_count = self._count
        return True
