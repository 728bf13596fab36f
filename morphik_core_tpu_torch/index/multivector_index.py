"""Single-device multivector index: PyTorch port of
`morphik_core_tpu/index/multivector_index.py:94-1826` (all but the mesh
paths).

  - FDE vectors live in fixed-size device blocks, int8-quantized by
    default (per-row scale). Blocks are immutable once full, so a store
    re-uploads only the tail block.
  - Query = FDE encode + quantize on the device -> blocked matvec top-k
    (parallel/search.py) -> with the pooled tier, a pooled-MaxSim
    rescore of the ANN pool over the device-resident token-pooled int8
    rows (K1), keeping max(2k, 16, pool/10) survivors with the FDE-head
    union guard -> exact MaxSim rerank (K1 for int8, K2 for bf16),
    through the device candidate cache when it is on -> top-k.
    `use_pallas=False` (the reference's argument) runs the plain
    versions of K1/K2 on the same device instead.
  - Filtering = a device gate over per-row document codes.
  - Persistence, in the reference's file format (an index written by
    either package opens in the other): rows [0, _persisted) live in
    fde.bin / mv.bin / pooled.bin and are read through mmaps; rows
    [_persisted, _count) are the pending tail in host RAM until the next
    `save()`, which appends data, then the records.jsonl WAL, then
    fsyncs. Tombstones are compacted once the dead fraction crosses a
    threshold: streamed into a side directory and swapped in two-phase
    (a COMMIT marker makes an interrupted swap resumable).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.index.device_cache import DevicePoolCache
from morphik_core_tpu_torch.ops.fde import FDEConfig, fde_document_batch, fde_query
from morphik_core_tpu_torch.ops.maxsim import (
    maxsim_scores,
    maxsim_scores_q8,
    pad_multivectors,
    quantize_pool_int8,
    quantize_query_q8,
)
from morphik_core_tpu_torch.ops.pooling import pool_multivector, pooled_token_count
from morphik_core_tpu_torch.parallel.search import (
    quantize_rows_int8,
    quantize_vec_int8,
    scan_blocks_topk,
    scan_blocks_topk_pooled,
    scan_blocks_topk_q,
    scan_blocks_topk_q_pooled,
)

logger = logging.getLogger(__name__)

FORMAT_VERSION = 2
_STORE_FDE_BATCH = 64  # documents per device FDE encode in `encode_documents`
_POOLED_CHUNK_ROWS = 2048  # rows per host quantize pass when building a pooled block


def _fsync_dir(path: Path) -> None:
    """Make directory entries (file creations, renames) durable."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # platforms without directory fsync
        pass


def _round_capacity(n: int, minimum: int = 1024) -> int:
    """Power-of-2 capacity rounding (the reference's block geometry)."""
    c = minimum
    while c < n:
        c *= 2
    return c


def _add_op(rec: "IndexRecord") -> dict:
    """The WAL line of an added row, keys in the reference's order (the
    files are byte-identical across the two packages)."""
    return {
        "op": "add",
        "document_id": rec.document_id,
        "chunk_number": rec.chunk_number,
        "metadata": rec.metadata,
        "content_key": rec.content_key,
        "n_tokens": rec.n_tokens,
    }


@dataclass
class IndexRecord:
    document_id: str
    chunk_number: int
    metadata: Dict[str, Any] = field(default_factory=dict)
    content_key: Optional[str] = None
    n_tokens: int = 0


class MultiVectorIndex:
    """One namespace worth of chunk multivectors on one device."""

    def __init__(
        self,
        fde_config: Optional[FDEConfig] = None,
        *,
        device=None,
        prefilter_multiplier: int = 30,
        prefilter_cap: int = 300,
        store_dtype=np.float16,
        path: Optional[str | Path] = None,
        use_pallas: Optional[bool] = None,  # None/True: the kernels; False: their plain versions
        ann_dtype: str = "int8",  # "int8" | "bfloat16" | "float32"
        device_block_rows: int = 65536,
        compact_dead_fraction: float = 0.25,
        compact_min_rows: int = 4096,
        device_cache_slots: int = 0,
        device_cache_token_bucket: int = 1024,
        rerank_dtype: str = "bf16",  # "bf16" | "int8" (per-token scales)
        rerank_prefilter_pooling: int = 0,  # 0/1 = off; p>1 = pooled first pass
        pooled_tier_factor: int = 0,  # 0 = off; p>1 = device-resident pooled tier
        pooled_tier_budget_mb: int = 6144,
        pooled_refine_iters: int = 3,
        query_token_dedup: float = 0.98,
    ):
        if rerank_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown rerank_dtype {rerank_dtype!r}")
        if ann_dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"unknown ann_dtype {ann_dtype!r}")
        self.fde_config = fde_config or FDEConfig()
        self.device = torch.device(device) if device is not None else default_device()
        self.prefilter_multiplier = prefilter_multiplier
        self.prefilter_cap = prefilter_cap
        self.store_dtype = np.dtype(store_dtype)
        self.use_pallas = use_pallas
        self._use_kernel = use_pallas is not False
        self.path = Path(path) if path else None
        self.ann_dtype = ann_dtype
        self.block_rows = int(device_block_rows)
        self.compact_dead_fraction = compact_dead_fraction
        self.compact_min_rows = compact_min_rows
        self.rerank_dtype = rerank_dtype
        self.rerank_prefilter_pooling = int(rerank_prefilter_pooling)
        self.pooled_tier_factor = int(pooled_tier_factor)
        self.pooled_tier_budget_mb = int(pooled_tier_budget_mb)
        self.pooled_refine_iters = int(pooled_refine_iters)
        self.query_token_dedup = float(query_token_dedup)

        self._lock = threading.RLock()
        self.records: List[IndexRecord] = []
        self._id_to_row: Dict[str, int] = {}
        self._doc_rows: Dict[str, List[int]] = {}
        self._alive = np.zeros(0, dtype=bool)
        self._count = 0
        self._dead = 0
        self._doc_index: Dict[str, int] = {}  # doc_id -> code
        self._doc_alive: Dict[str, int] = {}  # doc_id -> alive row count
        self._row_code: List[int] = []
        self._fde_dim = self.fde_config.fde_dim
        self._dim = self.fde_config.dimension
        self._max_tokens = 0

        # persistence: rows [0, _persisted) are in the files (mmap-read),
        # rows [_persisted, _count) are the pending tail
        self._persisted = 0
        self._mv_off: List[int] = []  # per-row token offset into mv.bin (-1 = pending)
        self._fde_mm: Optional[np.memmap] = None
        self._mv_mm: Optional[np.memmap] = None
        self._fde_pending: List[np.ndarray] = []  # per row, f32
        self._mv_pending: List[np.ndarray] = []  # per row, store dtype
        self._wal_buffer: List[dict] = []  # ops since the last save, in order
        self._mv_file_tokens = 0
        # pooled.bin: each row's tier-factor pooled vector, computed once
        # at ingest, so a reload never replays the k-means refinement. A
        # header whose (factor, refine_iters) differs disables the store
        # until the next compaction rewrites it.
        self._pooled_pending: List[np.ndarray] = []
        self._pooled_off: List[int] = []  # per-row token offset (-1 = pending)
        self._pooled_mm: Optional[np.memmap] = None
        self._pooled_file_tokens = 0
        self._pooled_store_ok = self.pooled_tier_factor > 1

        # device state: block geometry grows pow-2 with the corpus, caps
        # at block_rows; full blocks below the watermarks stay resident
        self._active_block = 0
        self._dev_blocks: List[Any] = []  # (int8, scales) tuples or float tensors
        self._dev_rows = 0
        self._mask_blocks: List[torch.Tensor] = []
        self._mask_rows = 0
        self._code_blocks: List[torch.Tensor] = []
        self._code_rows = 0
        self._pooled_blocks: List[torch.Tensor] = []  # (B, T, D) int8
        self._pooled_scales: List[torch.Tensor] = []  # (B, T) f32, 0 = padded token
        self._pooled_masks: List[torch.Tensor] = []  # (B, T) f32, scale > 0
        self._pooled_rows = 0
        self._pooled_bucket = 0
        self._allowed_ones: Dict[int, torch.Tensor] = {}
        self._zeros_codes_cache: Optional[torch.Tensor] = None
        self._cache_slots = int(device_cache_slots)
        self._cache_bucket = int(device_cache_token_bucket)
        self._pool_cache: Optional[DevicePoolCache] = None
        self._pooled_cache: Optional[DevicePoolCache] = None
        self.last_timing: Dict[str, Any] = {}

        if self.path:
            # finish or discard an interrupted compaction before loading
            self.recover_compact(self.path)
        if self.path and ((self.path / "records.jsonl").exists() or (self.path / "meta.json").exists()):
            self._load()

    # ------------------------------------------------------------------ size

    def __len__(self) -> int:
        return self._count - self._dead

    @property
    def count_rows(self) -> int:
        return self._count

    @property
    def dead_fraction(self) -> float:
        return self._dead / self._count if self._count else 0.0

    def _invalidate_row_caches(self, row: int) -> None:
        for cache in (self._pool_cache, self._pooled_cache):
            if cache is not None:
                cache.invalidate(row)

    def _invalidate_all_caches(self) -> None:
        for cache in (self._pool_cache, self._pooled_cache):
            if cache is not None:
                cache.invalidate_all()

    # ----------------------------------------------------------------- store

    def store(
        self,
        multivectors: Sequence[np.ndarray],
        records: Sequence[IndexRecord],
        fde_vectors: Optional[np.ndarray] = None,
    ) -> List[str]:
        """Insert chunks; returns stored ids "docid-chunkno". Upsert: an
        existing (doc, chunk) row is tombstoned and re-appended. The
        tier-factor pooled vector of each row is computed here, at ingest."""
        if len(multivectors) != len(records):
            raise ValueError(f"{len(multivectors)} multivectors for {len(records)} records")
        if fde_vectors is None:
            fde_vectors = self.encode_documents(multivectors)
        ids = []
        with self._lock:
            need = self._count + len(records)
            if need > len(self._alive):
                alive = np.zeros(max(1024, 2 * need), dtype=bool)
                alive[: self._count] = self._alive[: self._count]
                self._alive = alive
            for mv, rec, fv in zip(multivectors, records, fde_vectors):
                sid = f"{rec.document_id}-{rec.chunk_number}"
                old = self._id_to_row.get(sid)
                if old is not None and self._alive[old]:
                    self._alive[old] = False
                    self._dead += 1
                    self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 1) - 1
                    self._mask_rows = min(self._mask_rows, old)
                    self._invalidate_row_caches(old)
                row = self._count
                mv = np.ascontiguousarray(mv, dtype=self.store_dtype)
                rec.n_tokens = int(mv.shape[0])
                self._max_tokens = max(self._max_tokens, rec.n_tokens)
                self.records.append(rec)
                self._mv_off.append(-1)
                self._mv_pending.append(mv)
                if self._pooled_store_ok:
                    self._pooled_pending.append(self._pool_row(mv))
                    self._pooled_off.append(-1)
                self._fde_pending.append(np.asarray(fv, dtype=np.float32))
                self._alive[row] = True
                self._id_to_row[sid] = row
                self._doc_rows.setdefault(rec.document_id, []).append(row)
                code = self._doc_index.setdefault(rec.document_id, len(self._doc_index))
                self._row_code.append(code)
                self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 0) + 1
                self._wal_buffer.append(_add_op(rec))
                self._count += 1
                ids.append(sid)
            self._maybe_compact()
        return ids

    def encode_documents(self, multivectors: Sequence[np.ndarray]) -> np.ndarray:
        """Batched document FDE on the index's device (ragged token counts
        padded and masked), in batches of `_STORE_FDE_BATCH` rows."""
        out = np.zeros((len(multivectors), self._fde_dim), dtype=np.float32)
        for s in range(0, len(multivectors), _STORE_FDE_BATCH):
            part = [np.asarray(m, np.float32) for m in multivectors[s : s + _STORE_FDE_BATCH]]
            dense, mask = pad_multivectors(part)
            fde = fde_document_batch(
                torch.from_numpy(dense).to(self.device), torch.from_numpy(mask).to(self.device),
                self.fde_config,
            )
            out[s : s + len(part)] = fde.cpu().numpy()
        return out

    def delete_document(self, document_id: str) -> int:
        with self._lock:
            rows = self._doc_rows.pop(document_id, [])
            n = 0
            for r in rows:
                if self._alive[r]:
                    self._alive[r] = False
                    self._dead += 1
                    n += 1
                    self._mask_rows = min(self._mask_rows, r)
                    self._invalidate_row_caches(r)
                sid = f"{self.records[r].document_id}-{self.records[r].chunk_number}"
                self._id_to_row.pop(sid, None)
            if n:
                self._doc_alive.pop(document_id, None)
                self._wal_buffer.append({"op": "del_doc", "document_id": document_id})
                self._maybe_compact()
            return n

    def get_chunks_by_id(self, chunk_ids: Sequence[Tuple[str, int]]) -> List[Optional[IndexRecord]]:
        """Records of live (document_id, chunk_number) rows, None where absent."""
        out = []
        for doc_id, chunk_no in chunk_ids:
            row = self._id_to_row.get(f"{doc_id}-{chunk_no}")
            out.append(self.records[row] if row is not None and self._alive[row] else None)
        return out

    def get_multivector(self, document_id: str, chunk_number: int) -> Optional[np.ndarray]:
        row = self._id_to_row.get(f"{document_id}-{chunk_number}")
        if row is None or not self._alive[row]:
            return None
        return self._mv_row(row).astype(np.float32)

    # --- row access: mmap for persisted rows, RAM for the pending tail -------

    def _fde_rows(self, start: int, stop: int) -> np.ndarray:
        """FDE vectors of rows [start, stop) as float32."""
        parts = []
        if start < self._persisted:
            parts.append(np.asarray(self._fde_mm[start : min(stop, self._persisted)]))
        if stop > self._persisted:
            lo = max(start, self._persisted) - self._persisted
            pend = self._fde_pending[lo : stop - self._persisted]
            if pend:
                parts.append(np.stack(pend))
        if not parts:
            return np.zeros((0, self._fde_dim), dtype=np.float32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _mv_row(self, row: int) -> np.ndarray:
        """One multivector (n_tokens, dim) in the store dtype."""
        if row >= self._persisted:
            return self._mv_pending[row - self._persisted]
        off = self._mv_off[row]
        return np.asarray(self._mv_mm[off : off + self.records[row].n_tokens])

    def _pool_row(self, mv: np.ndarray) -> np.ndarray:
        """Tier-factor pooled vector of one row, in the store dtype (the
        pooled.bin representation)."""
        pv = pool_multivector(
            np.asarray(mv, np.float32), self.pooled_tier_factor,
            refine_iters=self.pooled_refine_iters,
        )
        return np.ascontiguousarray(pv, dtype=self.store_dtype)

    def _pooled_row(self, row: int) -> np.ndarray:
        """One row's tier-factor pooled vector as f32: from the pending
        tail or pooled.bin, computed on the fly while the store is off."""
        if self._pooled_store_ok:
            if row >= self._persisted:
                return np.asarray(self._pooled_pending[row - self._persisted], np.float32)
            off = self._pooled_off[row] if row < len(self._pooled_off) else -1
            if off >= 0 and self._pooled_mm is not None:
                n = pooled_token_count(self.records[row].n_tokens, self.pooled_tier_factor)
                return np.asarray(self._pooled_mm[off : off + n], np.float32)
        return np.asarray(self._pool_row(self._mv_row(row)), np.float32)

    # --- device blocks -------------------------------------------------------

    def _sync_block_size(self) -> None:
        B = min(self.block_rows, _round_capacity(max(self._count, 1)))
        if B != self._active_block:
            self._active_block = B
            self._dev_blocks, self._dev_rows = [], 0
            self._mask_blocks, self._mask_rows = [], 0
            self._code_blocks, self._code_rows = [], 0
            self._pooled_blocks, self._pooled_scales, self._pooled_masks = [], [], []
            self._pooled_rows = 0

    def _span(self, b: int) -> Tuple[int, int]:
        B = self._active_block
        return b * B, min((b + 1) * B, self._count)

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # a read-only mmap slice or another framework's buffer
            x = x.copy()
        return torch.from_numpy(x).to(self.device)

    def _block_arrays(self, b: int):
        """Device payload for FDE block b, padded to B rows: (int8 rows,
        scales) for the int8 ANN, one float tensor otherwise."""
        B = self._active_block
        rows = self._fde_rows(*self._span(b))
        pad = B - rows.shape[0]
        if self.ann_dtype == "int8":
            q, s = quantize_rows_int8(rows)
            if pad:
                q = np.concatenate([q, np.zeros((pad, self._fde_dim), np.int8)])
                s = np.concatenate([s, np.ones(pad, np.float32)])
            return self._to_dev(q), self._to_dev(s)
        if pad:
            rows = np.concatenate([rows, np.zeros((pad, self._fde_dim), np.float32)])
        dt = torch.bfloat16 if self.ann_dtype == "bfloat16" else torch.float32
        return self._to_dev(rows).to(dt)

    def _n_blocks(self) -> int:
        return -(-self._count // self._active_block)

    def _ensure_device_blocks(self) -> None:
        self._sync_block_size()
        if self._dev_rows == self._count and self._dev_blocks:
            return
        first_dirty = self._dev_rows // self._active_block
        del self._dev_blocks[first_dirty:]
        for b in range(first_dirty, self._n_blocks()):
            self._dev_blocks.append(self._block_arrays(b))
        self._dev_rows = self._count

    def _ensure_mask_blocks(self) -> None:
        self._sync_block_size()
        if self._mask_rows == self._count and self._mask_blocks:
            return
        B = self._active_block
        first_dirty = min(self._mask_rows // B, len(self._mask_blocks))
        del self._mask_blocks[first_dirty:]
        for b in range(first_dirty, self._n_blocks()):
            lo, hi = self._span(b)
            m = np.zeros(B, np.float32)
            m[: hi - lo] = self._alive[lo:hi]
            self._mask_blocks.append(self._to_dev(m))
        self._mask_rows = self._count

    def _ensure_code_blocks(self) -> None:
        """Per-row document codes on the device, built only for filtered
        queries (unfiltered ones gate through a shared zeros block)."""
        self._sync_block_size()
        if self._code_rows == self._count and self._code_blocks:
            return
        B = self._active_block
        first_dirty = min(self._code_rows // B, len(self._code_blocks))
        del self._code_blocks[first_dirty:]
        for b in range(first_dirty, self._n_blocks()):
            lo, hi = self._span(b)
            c = np.zeros(B, np.int64)
            c[: hi - lo] = self._row_code[lo:hi]
            self._code_blocks.append(self._to_dev(c))
        self._code_rows = self._count

    def _codes(self, doc_ids) -> tuple:
        if doc_ids is not None:
            self._ensure_code_blocks()
            return tuple(self._code_blocks)
        B = self._active_block
        z = self._zeros_codes_cache
        if z is None or z.shape[0] != B:
            z = self._zeros_codes_cache = torch.zeros(B, dtype=torch.long, device=self.device)
        return (z,) * len(self._dev_blocks)

    # --- device-resident pooled tier ------------------------------------------

    def _tier_bucket(self) -> int:
        """Pooled token bucket: the widest pooled row (rows of n <= factor
        stay unpooled) rounded up to a multiple of 8."""
        p = self.pooled_tier_factor
        mt = max(self._max_tokens, 1)
        n = max(pooled_token_count(mt, p), min(mt, p))
        return max(8, -(-n // 8) * 8)

    def tier_bytes_estimate(self) -> int:
        self._sync_block_size()
        B = self._active_block
        n_blocks = -(-max(self._count, 1) // B)
        return n_blocks * B * self._tier_bucket() * (self._dim + 4)

    def _tier_active(self) -> bool:
        if self.pooled_tier_factor <= 1 or self._count == 0:
            return False
        return self.tier_bytes_estimate() <= self.pooled_tier_budget_mb * (1 << 20)

    def _pooled_block_host(self, b: int, bucket: int):
        """Per-token int8 + scales for pooled block b; scale 0 marks a
        padded token. Built in row chunks: a 64k-row block at once would
        need GBs of f32 temporaries. Pooled vectors come from the pooled
        store, so this is a read and quantize pass, not a k-means replay."""
        B = self._active_block
        lo, hi = self._span(b)
        q8 = np.zeros((B, bucket, self._dim), np.int8)
        sc = np.zeros((B, bucket), np.float32)
        for start in range(lo, hi, _POOLED_CHUNK_ROWS):
            stop = min(start + _POOLED_CHUNK_ROWS, hi)
            dense = np.zeros((stop - start, bucket, self._dim), np.float32)
            for j, r in enumerate(range(start, stop)):
                if not self._alive[r]:
                    continue  # tombstones are never gathered
                pv = self._pooled_row(r)
                n = min(pv.shape[0], bucket)
                dense[j, :n] = pv[:n]
            qq, ss = quantize_rows_int8(dense)
            q8[start - lo : stop - lo] = qq
            sc[start - lo : stop - lo] = ss * (np.abs(dense).max(axis=-1) > 0)
        return q8, sc

    def _ensure_pooled_blocks(self) -> None:
        self._sync_block_size()
        bucket = self._tier_bucket()
        if bucket != self._pooled_bucket:
            self._pooled_blocks, self._pooled_scales, self._pooled_masks = [], [], []
            self._pooled_rows = 0
            self._pooled_bucket = bucket
        if self._pooled_rows == self._count and self._pooled_blocks:
            return
        first_dirty = self._pooled_rows // self._active_block
        for lst in (self._pooled_blocks, self._pooled_scales, self._pooled_masks):
            del lst[first_dirty:]
        for b in range(first_dirty, self._n_blocks()):
            q8, sc = self._pooled_block_host(b, bucket)
            sc_t = self._to_dev(sc)
            self._pooled_blocks.append(self._to_dev(q8))
            self._pooled_scales.append(sc_t)
            self._pooled_masks.append((sc_t > 0).float())
        self._pooled_rows = self._count

    def _unpack(self, packed: torch.Tensor, limit: int) -> List[int]:
        packed = packed.cpu().numpy()  # one fetch: [scores | row ids]
        half = packed.shape[0] // 2
        vals, gids = packed[:half], packed[half:].astype(np.int64)
        out = [int(g) for g, s in zip(gids, vals) if np.isfinite(s) and g < self._count]
        return out[:limit]

    def _ann_pooled_topm(self, qe, q: np.ndarray, doc_ids, pool_size: int, m: int) -> List[int]:
        """Blocked ANN scan -> top-pool -> pooled MaxSim rescore over the
        device tier -> top-m survivors (first m//2 = the FDE head)."""
        self._ensure_device_blocks()
        self._ensure_mask_blocks()
        self._ensure_pooled_blocks()
        kb = min(_round_capacity(pool_size, minimum=16), self._active_block)
        masks = tuple(self._mask_blocks)
        codes = self._codes(doc_ids)
        allowed = self._allowed_vec(doc_ids)
        q8p, qsp = quantize_query_q8(q)
        q8p, qsp = self._to_dev(q8p), self._to_dev(qsp)
        m_pad = min(_round_capacity(m, minimum=16), pool_size)
        guard = m // 2
        tier = (tuple(self._pooled_blocks), tuple(self._pooled_scales), tuple(self._pooled_masks))
        if self.ann_dtype == "int8":
            q_dev, qs_dev = qe
            packed = scan_blocks_topk_q_pooled(
                tuple(b[0] for b in self._dev_blocks), tuple(b[1] for b in self._dev_blocks),
                masks, codes, allowed, q_dev, qs_dev, *tier, q8p, qsp,
                kb, pool_size, m_pad, guard=guard, use_kernel=self._use_kernel,
            )
        else:
            packed = scan_blocks_topk_pooled(
                tuple(self._dev_blocks), masks, codes, allowed, qe, *tier, q8p, qsp,
                kb, pool_size, m_pad, guard=guard, use_kernel=self._use_kernel,
            )
        return self._unpack(packed, m)

    # --- filtered-query gate ----------------------------------------------

    def _allowed_vec(self, doc_ids: Optional[Sequence[str]]) -> torch.Tensor:
        pad = _round_capacity(max(len(self._doc_index), 1), minimum=256)
        if doc_ids is None:
            ones = self._allowed_ones.get(pad)
            if ones is None:
                ones = torch.ones(pad, dtype=torch.float32, device=self.device)
                self._allowed_ones = {pad: ones}
            return ones
        a = np.zeros(pad, np.float32)
        for d in doc_ids:
            c = self._doc_index.get(d)
            if c is not None:
                a[c] = 1.0
        return self._to_dev(a)

    # --- query -------------------------------------------------------------

    def _dedup_query_tokens(self, q: np.ndarray) -> np.ndarray:
        """Greedy cosine dedup of query tokens for the selection stages;
        keeps the first representative of each near-duplicate cluster."""
        thr = self.query_token_dedup
        if thr <= 0 or q.shape[0] <= 64:
            return q
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
        kept: List[int] = []
        reps = np.empty_like(qn)
        for i in range(qn.shape[0]):
            if kept and float((reps[: len(kept)] @ qn[i]).max()) >= thr:
                continue
            reps[len(kept)] = qn[i]
            kept.append(i)
        return q[kept]

    def _encode_query(self, q: np.ndarray):
        """FDE-encode one query on the device; the int8 ANN also quantizes
        there and the result never visits the host."""
        fq = fde_query(self._to_dev(np.asarray(q, np.float32)), self.fde_config)
        if self.ann_dtype == "int8":
            return quantize_vec_int8(fq)
        return fq

    def _ann_pool(self, qe, doc_ids, pool_size: int) -> List[int]:
        """Top-`pool_size` candidate rows by FDE dot product."""
        allowed = self._allowed_vec(doc_ids)
        self._ensure_device_blocks()
        self._ensure_mask_blocks()
        kb = min(_round_capacity(pool_size, minimum=16), self._active_block)
        masks = tuple(self._mask_blocks)
        codes = self._codes(doc_ids)
        if self.ann_dtype == "int8":
            q_dev, qs_dev = qe
            packed = scan_blocks_topk_q(
                tuple(b[0] for b in self._dev_blocks), tuple(b[1] for b in self._dev_blocks),
                masks, codes, allowed, q_dev, qs_dev, kb, pool_size,
            )
        else:
            packed = scan_blocks_topk(tuple(self._dev_blocks), masks, codes, allowed, qe, kb, pool_size)
        return self._unpack(packed, pool_size)

    def query(
        self,
        query_embedding: np.ndarray,
        k: int,
        doc_ids: Optional[Sequence[str]] = None,
        return_timing: bool = False,
    ) -> List[Tuple[IndexRecord, float]]:
        """FDE ANN pool -> (pooled survivors) -> exact MaxSim rerank ->
        top-k. Returns [(record, score)] best-first."""
        with self._lock:
            t0 = time.perf_counter()
            if self._count == 0 or k <= 0:
                return []
            q = np.asarray(query_embedding, dtype=np.float32)
            # selection stages see the deduped query; the exact rerank
            # keeps the full q, so returned scores are unchanged
            q_sel = self._dedup_query_tokens(q)
            qe = self._encode_query(q_sel)
            t1 = time.perf_counter()
            pool_size = min(self.prefilter_multiplier * k, self.prefilter_cap)
            pool_size = min(max(pool_size, k), self._count)
            if doc_ids is not None:
                if not any(self._doc_alive.get(d, 0) > 0 for d in doc_ids):
                    return []
            elif len(self) == 0:
                return []
            rescore_n = max(2 * k, 16, pool_size // 10)
            tier = self._tier_active() and pool_size > rescore_n
            if tier:
                pool = self._ann_pooled_topm(qe, q_sel, doc_ids, pool_size, rescore_n)
            else:
                pool = self._ann_pool(qe, doc_ids, pool_size)
            t2 = time.perf_counter()
            if not pool:
                return []
            resident = self._pool_cache is not None and self._pool_cache.resident(pool)
            p = self.rerank_prefilter_pooling
            if not tier and not resident and p > 1 and len(pool) > rescore_n:
                pool = self._pooled_prefilter(pool, q_sel, rescore_n, p)
            rescores = self._pool_scores_cached(pool, q) if self._cache_slots > 0 else None
            if rescores is None:
                rescores = self._rerank_cold(pool, q)
            # stable sort: equal scores keep pool order
            order = np.argsort(-rescores, kind="stable")[: min(k, len(pool))]
            t3 = time.perf_counter()
            if return_timing:
                self.last_timing = {
                    "encode_ms": (t1 - t0) * 1e3,
                    "ann_ms": (t2 - t1) * 1e3,
                    "rerank_ms": (t3 - t2) * 1e3,
                    "pool": len(pool),
                    "pooled_tier": tier,
                }
            return [(self.records[pool[i]], float(rescores[i])) for i in order]

    def _rerank_cold(self, pool: List[int], q: np.ndarray) -> np.ndarray:
        """Exact MaxSim of `pool` with a direct upload (cache off, or a
        row longer than the cache bucket)."""
        cand = [self._mv_row(r) for r in pool]
        if self.rerank_dtype == "int8":
            d8, ds, dmask = quantize_pool_int8([np.asarray(c, np.float32) for c in cand])
            return maxsim_scores_q8(q, d8, ds, dmask, device=self.device,
                                    use_kernel=self._use_kernel).cpu().numpy()
        dense, dmask = pad_multivectors(cand, dtype=self.store_dtype)
        docs = self._to_dev(dense)
        if docs.dtype == torch.float16:
            docs = docs.to(torch.bfloat16)  # the reference's f16 -> bf16 store cast
        return maxsim_scores(q, docs, self._to_dev(dmask), use_kernel=self._use_kernel).cpu().numpy()

    def _pooled_prefilter(self, pool: List[int], q: np.ndarray, m: int, factor: int) -> List[int]:
        """Rank `pool` by MaxSim over token-pooled int8 rows and keep `m`
        survivors: the first m//2 by FDE order (union guard), the rest by
        pooled score. Used when the device tier is off."""

        def fetch_pooled(r: int) -> np.ndarray:
            if factor == self.pooled_tier_factor:
                return self._pooled_row(r)  # computed at ingest: no k-means here
            return pool_multivector(
                np.asarray(self._mv_row(r), np.float32), factor, refine_iters=self.pooled_refine_iters,
            )

        scores = None
        if self._cache_slots > 0 and len(pool) <= self._cache_slots:
            if self._pooled_cache is None:
                pooled_max = -(-self._cache_bucket // factor)
                bucket = max(8, -(-pooled_max // 8) * 8)
                self._pooled_cache = DevicePoolCache(
                    self._cache_slots, bucket, self._dim, self.device, quantized=True
                )
            scores = self._pooled_cache.score(
                pool, q, fetch_row=fetch_pooled,
                n_tokens=lambda r: pooled_token_count(self.records[r].n_tokens, factor),
                use_kernel=self._use_kernel,
            )
        if scores is None:
            d8, ds, dmask = quantize_pool_int8([fetch_pooled(r) for r in pool])
            scores = maxsim_scores_q8(q, d8, ds, dmask, device=self.device,
                                      use_kernel=self._use_kernel).cpu().numpy()
        m = min(m, len(pool))
        g = m // 2
        order = [i for i in np.argsort(-scores, kind="stable") if i >= g]
        return pool[:g] + [pool[i] for i in order[: m - g]]

    def _pool_scores_cached(self, pool: List[int], q: np.ndarray) -> Optional[np.ndarray]:
        """Exact MaxSim via the device candidate cache; None -> direct path."""
        if len(pool) > self._cache_slots:
            return None
        if self._pool_cache is None:
            self._pool_cache = DevicePoolCache(
                self._cache_slots, self._cache_bucket, self._dim, self.device,
                quantized=self.rerank_dtype == "int8",
            )
        return self._pool_cache.score(
            pool, q, fetch_row=self._mv_row, n_tokens=lambda r: self.records[r].n_tokens,
            use_kernel=self._use_kernel,
        )

    # ------------------------------------------------------------- persistence
    #
    # Layout under self.path (the reference's, byte for byte):
    #   header.json    format version, store dtype, pooled meta, FDE config
    #   records.jsonl  append-only op log (add / del_doc), replayed on load
    #   fde.bin        raw float32 rows, appended in row order
    #   mv.bin         raw store-dtype tokens, appended; a row is located by
    #                  (token offset, n_tokens)
    #   pooled.bin     raw store-dtype pooled tokens; offsets follow from
    #                  the records' n_tokens

    def _header(self) -> dict:
        return {
            "format": FORMAT_VERSION,
            "store_dtype": self.store_dtype.name,
            "pooled": {
                "factor": self.pooled_tier_factor,
                "refine_iters": self.pooled_refine_iters,
            },
            "fde": {
                "dimension": self.fde_config.dimension,
                "num_repetitions": self.fde_config.num_repetitions,
                "num_simhash_projections": self.fde_config.num_simhash_projections,
                "projection_dimension": self.fde_config.projection_dimension,
                "projection_type": self.fde_config.projection_type,
                "seed": self.fde_config.seed,
            },
        }

    def save(self) -> None:
        """Flush the pending tail: O(rows since the last save). Data is
        appended before the WAL lines that reference it, then the WAL is
        fsynced: a crash in between leaves orphan bytes that `_load`
        truncates."""
        if not self.path:
            raise ValueError("index created without a path")
        with self._lock:
            self.path.mkdir(parents=True, exist_ok=True)
            hdr = self.path / "header.json"
            if not hdr.exists():
                with open(hdr, "w") as fh:
                    json.dump(self._header(), fh)
            # records.jsonl exists even for an empty index: a zero-survivor
            # compaction swap replaces the old WAL with it, so no deleted
            # row comes back on reload
            wal = self.path / "records.jsonl"
            if not wal.exists():
                wal.touch()
            if not self._wal_buffer and self._persisted == self._count:
                return
            if self._fde_pending:
                with open(self.path / "fde.bin", "ab") as fh:
                    fh.write(np.stack(self._fde_pending).tobytes())
            new_offs, self._mv_file_tokens = self._append_rows("mv.bin", self._mv_pending, self._mv_file_tokens)
            new_pooled_offs: List[int] = []
            if self._pooled_store_ok:
                new_pooled_offs, self._pooled_file_tokens = self._append_rows(
                    "pooled.bin", self._pooled_pending, self._pooled_file_tokens)
            it = iter(new_offs)
            lines = [json.dumps({**op, "mv_off": next(it)} if op["op"] == "add" else op, default=str)
                     for op in self._wal_buffer]
            with open(wal, "a") as fh:
                fh.write("".join(line + "\n" for line in lines))
                fh.flush()
                os.fsync(fh.fileno())
            for i, off in enumerate(new_offs):
                self._mv_off[self._persisted + i] = off
            for i, off in enumerate(new_pooled_offs):
                self._pooled_off[self._persisted + i] = off
            self._persisted = self._count
            self._fde_pending.clear()
            self._mv_pending.clear()
            self._pooled_pending.clear()
            self._wal_buffer.clear()
            self._open_mmaps()

    def _append_rows(self, name: str, rows: List[np.ndarray], off: int) -> Tuple[List[int], int]:
        """Append ragged rows to `name`, whose rows so far hold `off`
        tokens. Returns each row's token offset and the new token count."""
        offs = []
        for r in rows:
            offs.append(off)
            off += r.shape[0]
        if rows:
            with open(self.path / name, "ab") as fh:
                fh.write(b"".join(r.tobytes() for r in rows))
        return offs, off

    def _open_mmaps(self) -> None:
        fde_p, mv_p, pooled_p = self.path / "fde.bin", self.path / "mv.bin", self.path / "pooled.bin"
        if self._persisted and fde_p.exists():
            self._fde_mm = np.memmap(fde_p, dtype=np.float32, mode="r", shape=(self._persisted, self._fde_dim))
        if self._mv_file_tokens and mv_p.exists():
            self._mv_mm = np.memmap(mv_p, dtype=self.store_dtype, mode="r",
                                    shape=(self._mv_file_tokens, self._dim))
        if self._pooled_store_ok and self._pooled_file_tokens and pooled_p.exists():
            self._pooled_mm = np.memmap(pooled_p, dtype=self.store_dtype, mode="r",
                                        shape=(self._pooled_file_tokens, self._dim))

    def _tokens_on_disk(self, name: str) -> int:
        p = self.path / name
        return p.stat().st_size // (self.store_dtype.itemsize * self._dim) if p.exists() else 0

    def _load(self) -> None:
        """Replay the WAL over the data files. Replay stops at a truncated
        line or at a line whose data is missing; orphan data bytes past the
        last replayed row are truncated, so later appends stay aligned."""
        if not (self.path / "records.jsonl").exists():
            self._load_legacy()
            return
        with open(self.path / "header.json") as fh:
            hdr = json.load(fh)
        stored, current = hdr["fde"], self._header()["fde"]
        # every field matters: dims change the row stride, the seed the
        # projections (same shapes, broken retrieval)
        if stored != current:
            raise ValueError(
                f"index at {self.path} was built with a different FDE config: "
                f"stored={stored} configured={current}"
            )
        self.store_dtype = np.dtype(hdr.get("store_dtype", "float16"))
        fde_p = self.path / "fde.bin"
        fde_rows_on_disk = fde_p.stat().st_size // (4 * self._fde_dim) if fde_p.exists() else 0
        mv_tokens_on_disk = self._tokens_on_disk("mv.bin")
        with open(self.path / "records.jsonl") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("truncated WAL line in %s: stopping replay", self.path)
                    break
                if op["op"] == "add":
                    row = self._count
                    if row >= fde_rows_on_disk or op["mv_off"] + op["n_tokens"] > mv_tokens_on_disk:
                        logger.warning("WAL references missing data in %s: stopping replay", self.path)
                        break
                    self._replay_add(op)
                elif op["op"] == "del_doc":
                    for r in self._doc_rows.pop(op["document_id"], []):
                        if self._alive[r]:
                            self._alive[r] = False
                            self._dead += 1
                        self._id_to_row.pop(f"{self.records[r].document_id}-{self.records[r].chunk_number}", None)
                    self._doc_alive.pop(op["document_id"], None)
        self._persisted = self._count
        if fde_rows_on_disk > self._count:
            with open(fde_p, "r+b") as fh:
                fh.truncate(self._count * 4 * self._fde_dim)
        used_tokens = max((self._mv_off[r] + self.records[r].n_tokens for r in range(self._count)), default=0)
        if mv_tokens_on_disk > used_tokens:
            with open(self.path / "mv.bin", "r+b") as fh:
                fh.truncate(used_tokens * self.store_dtype.itemsize * self._dim)
        self._mv_file_tokens = used_tokens
        self._load_pooled_store(hdr)
        self._open_mmaps()

    def _replay_add(self, op: dict) -> None:
        row = self._count
        rec = IndexRecord(
            document_id=op["document_id"],
            chunk_number=op["chunk_number"],
            metadata=op.get("metadata") or {},
            content_key=op.get("content_key"),
            n_tokens=op["n_tokens"],
        )
        self._max_tokens = max(self._max_tokens, rec.n_tokens)
        sid = f"{rec.document_id}-{rec.chunk_number}"
        old = self._id_to_row.get(sid)
        if row >= len(self._alive):
            alive = np.zeros(max(1024, 2 * (row + 1)), dtype=bool)
            alive[: self._count] = self._alive[: self._count]
            self._alive = alive
        if old is not None and self._alive[old]:
            self._alive[old] = False
            self._dead += 1
            self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 1) - 1
        self.records.append(rec)
        self._mv_off.append(op["mv_off"])
        self._alive[row] = True
        self._id_to_row[sid] = row
        self._doc_rows.setdefault(rec.document_id, []).append(row)
        code = self._doc_index.setdefault(rec.document_id, len(self._doc_index))
        self._row_code.append(code)
        self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 0) + 1
        self._count += 1

    def _load_pooled_store(self, hdr: dict) -> None:
        """Hold pooled.bin to the header's pooled meta and the replayed
        records. A mismatch (legacy index, a changed factor or refine
        count, a short file) disables the store: pooled rows are computed
        on the fly until the next compaction rewrites the file. Derived
        data, so never a load error."""
        if self.pooled_tier_factor <= 1:
            self._pooled_store_ok = False
            return
        meta = hdr.get("pooled") or {}
        if meta.get("factor") != self.pooled_tier_factor or meta.get("refine_iters") != self.pooled_refine_iters:
            self._pooled_store_ok = False
            return
        on_disk = self._tokens_on_disk("pooled.bin")
        offs: List[int] = []
        off = 0
        for r in range(self._count):
            offs.append(off)
            off += pooled_token_count(self.records[r].n_tokens, self.pooled_tier_factor)
        if on_disk < off:
            self._pooled_store_ok = False
            return
        if on_disk > off:  # orphan bytes of a crashed append
            with open(self.path / "pooled.bin", "r+b") as fh:
                fh.truncate(off * self.store_dtype.itemsize * self._dim)
        self._pooled_off = offs
        self._pooled_file_tokens = off
        self._pooled_store_ok = True

    def _load_legacy(self) -> None:
        """Migrate the round-1 snapshot (meta.json + fde.npy +
        multivectors/{row}.npy) to the append-only format: stream the
        alive rows into a side directory, one .npy at a time, then commit
        with compaction's COMMIT swap, which also removes the legacy
        files. A crash mid-migration discards the side build."""
        with open(self.path / "meta.json") as fh:
            meta = json.load(fh)
        fde = np.load(self.path / "fde.npy", mmap_mode="r")
        mv_dir = self.path / "multivectors"
        tmp = self._side_dir()
        n_alive = 0
        with open(tmp / "fde.bin", "wb") as fde_f, open(tmp / "mv.bin", "wb") as mv_f, \
                open(tmp / "records.jsonl", "w") as wal_f:
            off_tokens = 0
            for i, rm in enumerate(meta["records"]):
                if not rm.get("alive", True):
                    continue
                f = mv_dir / f"{i}.npy"
                mv = np.load(f).astype(self.store_dtype) if f.exists() else np.zeros((0, self._dim), self.store_dtype)
                fde_f.write(np.ascontiguousarray(fde[i], dtype=np.float32).tobytes())
                mv_f.write(np.ascontiguousarray(mv).tobytes())
                # the stored token count, not the metadata's claim: the
                # mv_off accounting depends on it
                rec = IndexRecord(rm["document_id"], rm["chunk_number"], rm["metadata"],
                                  rm.get("content_key"), int(mv.shape[0]))
                wal_f.write(json.dumps({**_add_op(rec), "mv_off": off_tokens}, default=str) + "\n")
                off_tokens += int(mv.shape[0])
                n_alive += 1
            for f in (fde_f, mv_f, wal_f):
                f.flush()
                os.fsync(f.fileno())
        self._commit_side_dir(tmp)
        (self.path / "fde.npy").unlink(missing_ok=True)
        logger.info("migrated legacy snapshot at %s (%d alive rows)", self.path, n_alive)
        self._load()

    # ------------------------------------------------------------- compaction

    def _maybe_compact(self) -> None:
        if self._count >= self.compact_min_rows and self.dead_fraction > self.compact_dead_fraction:
            self.compact()

    _COMPACT_FILES = ("header.json", "records.jsonl", "fde.bin", "mv.bin", "pooled.bin")

    COMPACT_BATCH_ROWS = 4096  # streaming-copy granularity (bounds host RSS)

    def compact(self) -> None:
        """Drop tombstoned rows and renumber the rest. A persistent index
        streams its alive rows into a side directory and swaps it in
        two-phase (this object's state stays untouched until the side
        build succeeds), then reloads from the files; an index without a
        path rebuilds its state in memory. Both reset the device state."""
        with self._lock:
            if self.path and self.path.exists():
                kept = self._compact_streaming()
                self._reload_from_disk()
            else:
                keep = [r for r in range(self._count) if self._alive[r]]
                new_records = [
                    IndexRecord(
                        document_id=self.records[r].document_id,
                        chunk_number=self.records[r].chunk_number,
                        metadata=self.records[r].metadata,
                        content_key=self.records[r].content_key,
                        n_tokens=self.records[r].n_tokens,
                    )
                    for r in keep
                ]
                new_id_to_row: Dict[str, int] = {}
                new_doc_rows: Dict[str, List[int]] = {}
                for new_row, rec in enumerate(new_records):
                    new_id_to_row[f"{rec.document_id}-{rec.chunk_number}"] = new_row
                    new_doc_rows.setdefault(rec.document_id, []).append(new_row)
                self._reset_state(new_records, [self._fde_rows(r, r + 1)[0] for r in keep],
                                  [np.asarray(self._mv_row(r)) for r in keep], new_id_to_row, new_doc_rows)
                kept = len(new_records)
            logger.info("compacted index: %d rows kept", kept)

    def _side_dir(self) -> Path:
        """A fresh `<path>.compact` directory holding the current header."""
        tmp = self.path.with_name(self.path.name + ".compact")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with open(tmp / "header.json", "w") as fh:
            json.dump(self._header(), fh)
        return tmp

    def _commit_side_dir(self, tmp: Path) -> None:
        """The COMMIT marker, durable before any rename (a crash must never
        see replaced files without it), then the swap."""
        with open(tmp / "COMMIT", "w") as fh:
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(tmp)
        self._swap_compact_files(self.path, tmp)

    def _compact_streaming(self) -> int:
        """Stream the alive rows into the side directory in
        COMPACT_BATCH_ROWS batches, then COMMIT and swap. Returns the
        number of rows kept; the caller reloads."""
        tmp = self._side_dir()
        kept = 0
        write_pooled = self.pooled_tier_factor > 1
        pooled_f = open(tmp / "pooled.bin", "wb") if write_pooled else None
        try:
            with open(tmp / "fde.bin", "wb") as fde_f, open(tmp / "mv.bin", "wb") as mv_f, \
                    open(tmp / "records.jsonl", "w") as wal_f:
                off_tokens = 0
                batch_fde: List[np.ndarray] = []
                batch_mv: List[bytes] = []
                batch_pooled: List[bytes] = []
                batch_lines: List[str] = []

                def flush_batch() -> None:
                    if batch_fde:
                        fde_f.write(np.stack(batch_fde).tobytes())
                    if batch_mv:
                        mv_f.write(b"".join(batch_mv))
                    if pooled_f is not None and batch_pooled:
                        pooled_f.write(b"".join(batch_pooled))
                    wal_f.write("".join(line + "\n" for line in batch_lines))
                    for batch in (batch_fde, batch_mv, batch_pooled, batch_lines):
                        batch.clear()

                for r in range(self._count):
                    if not self._alive[r]:
                        continue
                    rec = self.records[r]
                    mv = np.ascontiguousarray(self._mv_row(r), dtype=self.store_dtype)
                    batch_fde.append(np.asarray(self._fde_rows(r, r + 1)[0], np.float32))
                    batch_mv.append(mv.tobytes())
                    if write_pooled:
                        # copied from a valid store, recomputed otherwise:
                        # compaction is what heals a disabled pooled store
                        pv = self._pooled_row(r).astype(self.store_dtype) if self._pooled_store_ok \
                            else self._pool_row(mv)
                        batch_pooled.append(np.ascontiguousarray(pv).tobytes())
                    batch_lines.append(json.dumps({**_add_op(rec), "mv_off": off_tokens}, default=str))
                    off_tokens += rec.n_tokens
                    kept += 1
                    if len(batch_lines) >= self.COMPACT_BATCH_ROWS:
                        flush_batch()
                flush_batch()
                # side files durable before the COMMIT marker: recovery
                # replays the swap assuming they are complete
                for f in [fde_f, mv_f, wal_f] + ([pooled_f] if pooled_f else []):
                    f.flush()
                    os.fsync(f.fileno())
        finally:
            if pooled_f is not None:
                pooled_f.close()
        self._commit_side_dir(tmp)
        return kept

    @classmethod
    def _swap_compact_files(cls, path: Path, tmp: Path) -> None:
        """Move the side-built files over the live ones. Idempotent: safe
        to run again after a crash at any point."""
        for name in cls._COMPACT_FILES:
            src = tmp / name
            if src.exists():
                os.replace(src, path / name)
            elif name == "pooled.bin":
                # a tier-off compaction leaves no stale pooled.bin (its
                # offsets no longer match the renumbered rows)
                (path / name).unlink(missing_ok=True)
        _fsync_dir(path)
        (path / "meta.json").unlink(missing_ok=True)  # the legacy snapshot is superseded
        legacy = path / "multivectors"
        if legacy.exists():
            shutil.rmtree(legacy, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)

    @classmethod
    def recover_compact(cls, path: Path) -> bool:
        """Finish (COMMIT marker present) or discard (no marker) an
        interrupted compaction. Returns True if a swap was completed."""
        tmp = Path(path).with_name(Path(path).name + ".compact")
        if not tmp.exists():
            return False
        if (tmp / "COMMIT").exists():
            logger.warning("completing interrupted compaction at %s", path)
            cls._swap_compact_files(Path(path), tmp)
            return True
        logger.warning("discarding incomplete compaction build at %s", tmp)
        shutil.rmtree(tmp, ignore_errors=True)
        return False

    def _reload_from_disk(self) -> None:
        """Re-derive all host and device state from the files (after a
        compaction swap)."""
        self.records = []
        self._id_to_row = {}
        self._doc_rows = {}
        self._alive = np.zeros(0, dtype=bool)
        self._count = 0
        self._dead = 0
        self._doc_index = {}
        self._doc_alive = {}
        self._row_code = []
        self._persisted = 0
        self._mv_off = []
        self._fde_mm = None
        self._mv_mm = None
        self._fde_pending = []
        self._mv_pending = []
        self._wal_buffer = []
        self._mv_file_tokens = 0
        self._pooled_pending = []
        self._pooled_off = []
        self._pooled_mm = None
        self._pooled_file_tokens = 0
        self._pooled_store_ok = self.pooled_tier_factor > 1
        self._max_tokens = 0
        self._reset_device_state()
        self._invalidate_all_caches()  # row ids were renumbered
        self._load()

    def _reset_device_state(self) -> None:
        self._dev_blocks = []
        self._dev_rows = 0
        self._mask_blocks = []
        self._mask_rows = 0
        self._code_blocks = []
        self._code_rows = 0
        self._allowed_ones = {}
        self._zeros_codes_cache = None
        self._pooled_blocks = []
        self._pooled_scales = []
        self._pooled_masks = []
        self._pooled_rows = 0
        self._pooled_bucket = 0

    def _reset_state(self, records, fde_pending, mv_pending, id_to_row, doc_rows) -> None:
        self.records = records
        self._fde_pending = fde_pending
        self._mv_pending = mv_pending
        self._id_to_row = id_to_row
        self._doc_rows = doc_rows
        self._count = len(records)
        self._dead = 0
        self._persisted = 0
        self._mv_off = [-1] * self._count
        self._mv_file_tokens = 0
        self._fde_mm = None
        self._mv_mm = None
        self._pooled_mm = None
        self._pooled_file_tokens = 0
        self._pooled_store_ok = self.pooled_tier_factor > 1
        self._pooled_off = [-1] * self._count if self._pooled_store_ok else []
        self._pooled_pending = [self._pool_row(mv) for mv in mv_pending] if self._pooled_store_ok else []
        alive = np.zeros(max(1024, 2 * max(self._count, 1)), dtype=bool)
        alive[: self._count] = True
        self._alive = alive
        self._doc_index = {}
        self._doc_alive = {}
        self._row_code = []
        self._max_tokens = 0
        for rec in records:
            code = self._doc_index.setdefault(rec.document_id, len(self._doc_index))
            self._row_code.append(code)
            self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 0) + 1
            self._max_tokens = max(self._max_tokens, rec.n_tokens)
        self._wal_buffer = [_add_op(r) for r in records]
        self._reset_device_state()
        self._invalidate_all_caches()  # compaction renumbers rows
