"""In-memory, single-device multivector index: PyTorch port of the device
half of `morphik_core_tpu/index/multivector_index.py:94-1211`.

  - FDE vectors live in fixed-size device blocks, int8-quantized by
    default (per-row scale). Blocks are immutable once full, so a store
    re-uploads only the tail block.
  - Query = FDE encode + quantize on the device -> blocked matvec top-k
    (parallel/search.py) -> with the pooled tier, a pooled-MaxSim
    rescore of the ANN pool over the device-resident token-pooled int8
    rows (K1), keeping max(2k, 16, pool/10) survivors with the FDE-head
    union guard -> exact MaxSim rerank (K1 for int8, K2 for bf16),
    through the device candidate cache when it is on -> top-k.
  - Filtering = a device gate over per-row document codes.

Not ported yet: the WAL, mmap persistence, compaction and the mesh
paths. Rows live in host RAM.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
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

_STORE_FDE_BATCH = 64  # documents per device FDE encode in `encode_documents`
_POOLED_CHUNK_ROWS = 2048  # rows per host quantize pass when building a pooled block


def _round_capacity(n: int, minimum: int = 1024) -> int:
    """Power-of-2 capacity rounding (the reference's block geometry)."""
    c = minimum
    while c < n:
        c *= 2
    return c


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
        ann_dtype: str = "int8",  # "int8" | "bfloat16" | "float32"
        device_block_rows: int = 65536,
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
        self.ann_dtype = ann_dtype
        self.block_rows = int(device_block_rows)
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
        self._mv_rows: List[np.ndarray] = []  # per row, store dtype
        self._fde_host: List[np.ndarray] = []  # per row, f32
        self._pooled_host: List[np.ndarray] = []  # per row, tier-factor pooled, store dtype
        self._max_tokens = 0

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

    # ------------------------------------------------------------------ size

    def __len__(self) -> int:
        return self._count - self._dead

    def _invalidate_row_caches(self, row: int) -> None:
        for cache in (self._pool_cache, self._pooled_cache):
            if cache is not None:
                cache.invalidate(row)

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
                self._mv_rows.append(mv)
                if self.pooled_tier_factor > 1:
                    self._pooled_host.append(self._pool_row(mv))
                self._fde_host.append(np.asarray(fv, dtype=np.float32))
                self._alive[row] = True
                self._id_to_row[sid] = row
                self._doc_rows.setdefault(rec.document_id, []).append(row)
                code = self._doc_index.setdefault(rec.document_id, len(self._doc_index))
                self._row_code.append(code)
                self._doc_alive[rec.document_id] = self._doc_alive.get(rec.document_id, 0) + 1
                self._count += 1
                ids.append(sid)
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
            return n

    def get_chunks_by_id(self, chunk_ids: Sequence[Tuple[str, int]]) -> List[Optional[IndexRecord]]:
        """Records of live (document_id, chunk_number) rows, None where absent."""
        out = []
        for doc_id, chunk_no in chunk_ids:
            row = self._id_to_row.get(f"{doc_id}-{chunk_no}")
            out.append(self.records[row] if row is not None and self._alive[row] else None)
        return out

    def _mv_row(self, row: int) -> np.ndarray:
        return self._mv_rows[row]

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
        if not x.flags.writeable:  # e.g. a view of another framework's buffer
            x = x.copy()
        return torch.from_numpy(x).to(self.device)

    def _block_arrays(self, b: int):
        """Device payload for FDE block b, padded to B rows: (int8 rows,
        scales) for the int8 ANN, one float tensor otherwise."""
        B = self._active_block
        lo, hi = self._span(b)
        rows = np.stack(self._fde_host[lo:hi])
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

    def _pool_row(self, mv: np.ndarray) -> np.ndarray:
        pv = pool_multivector(
            np.asarray(mv, np.float32), self.pooled_tier_factor,
            refine_iters=self.pooled_refine_iters,
        )
        return np.ascontiguousarray(pv, dtype=self.store_dtype)

    def _pooled_block_host(self, b: int, bucket: int):
        """Per-token int8 + scales for pooled block b; scale 0 marks a
        padded token. Built in row chunks: a 64k-row block at once would
        need GBs of f32 temporaries."""
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
                pv = self._pooled_host[r]
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
                kb, pool_size, m_pad, guard=guard,
            )
        else:
            packed = scan_blocks_topk_pooled(
                tuple(self._dev_blocks), masks, codes, allowed, qe, *tier, q8p, qsp,
                kb, pool_size, m_pad, guard=guard,
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
            return maxsim_scores_q8(q, d8, ds, dmask, device=self.device).cpu().numpy()
        dense, dmask = pad_multivectors(cand, dtype=self.store_dtype)
        docs = self._to_dev(dense)
        if docs.dtype == torch.float16:
            docs = docs.to(torch.bfloat16)  # the reference's f16 -> bf16 store cast
        return maxsim_scores(q, docs, self._to_dev(dmask)).cpu().numpy()

    def _pooled_prefilter(self, pool: List[int], q: np.ndarray, m: int, factor: int) -> List[int]:
        """Rank `pool` by MaxSim over token-pooled int8 rows and keep `m`
        survivors: the first m//2 by FDE order (union guard), the rest by
        pooled score. Used when the device tier is off."""

        def fetch_pooled(r: int) -> np.ndarray:
            if factor == self.pooled_tier_factor:
                return np.asarray(self._pooled_host[r], np.float32)
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
            )
        if scores is None:
            d8, ds, dmask = quantize_pool_int8([fetch_pooled(r) for r in pool])
            scores = maxsim_scores_q8(q, d8, ds, dmask, device=self.device).cpu().numpy()
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
        )
