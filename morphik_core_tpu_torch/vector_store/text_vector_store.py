"""Single-vector text store of the text path: port of
`morphik_core_tpu/vector_store/text_vector_store.py`, whole.

Cosine top-k over the stored embedding matrix, one namespace per app_id,
with an exact BM25 hybrid and npy/json persistence:
  - embeddings live in a capacity-doubling host matrix (amortized O(1)
    append). Past `DEVICE_SCAN_MIN_ROWS` rows a query scans them on the
    store's device: a preallocated buffer of `cap` rows that takes only
    the rows appended since the last query (`_tail_update`), then one
    masked matvec + top-M (`_masked_topm`: `buf @ q`, `masked_fill`,
    `torch.topk`). The alive mask is cached on the device; a `doc_ids`
    filter uploads a fresh mask.
  - BM25 uses an inverted index (term -> row postings), so the lexical
    half costs O(rows matching the query terms). The hybrid top-k is
    exact: candidates are the device top-M and the BM25-matching rows;
    any other row has zero BM25 and a cosine below the M-th.

The same `store` / `delete` / `save` calls write byte-identical
`{ns}.vectors.npy` and `{ns}.rows.json` files in both packages, and each
package opens the other's.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.models.schemas import DocumentChunk
from morphik_core_tpu_torch.vector_store.base_vector_store import BaseVectorStore

logger = logging.getLogger(__name__)

_DEFAULT_NS = "default"

_TOKEN_RE = re.compile(r"[a-z0-9]+")

_BM25_K1 = 1.5
_BM25_B = 0.75

#: below this many rows, a host matvec beats a device round trip
DEVICE_SCAN_MIN_ROWS = 50_000


def _tail_update(buf: torch.Tensor, rows: torch.Tensor, start: int) -> torch.Tensor:
    buf[start : start + rows.shape[0]].copy_(rows)
    return buf


def _masked_topm(buf: torch.Tensor, q: torch.Tensor, mask: torch.Tensor, m: int):
    """(values, indices) of the m best rows of `buf @ q` where mask > 0."""
    scores = (buf @ q).masked_fill(mask <= 0, float("-inf"))
    return torch.topk(scores, m)


class _Namespace:
    def __init__(self, device: torch.device, dim: Optional[int] = None):
        self.device = device
        self.dim = dim
        self.vectors = np.zeros((0, dim or 1), dtype=np.float32)  # capacity rows
        self.count = 0
        self.rows: List[DocumentChunk] = []
        self._id_to_row: Dict[str, int] = {}
        self.alive: List[bool] = []
        # BM25 corpus statistics + inverted index (exact; maintained on
        # store/delete; postings are append-only, dead rows masked out)
        self.tf: List[Counter] = []
        self.df: Counter = Counter()
        self.postings: Dict[str, List[int]] = {}
        self.total_len = 0  # sum of alive rows' token counts
        # device-resident scan state
        self.dev_buf: Optional[torch.Tensor] = None
        self.dev_rows = 0  # rows reflected in dev_buf
        self.dev_alive: Optional[torch.Tensor] = None
        self.dev_alive_rows = -1
        self.full_uploads = 0  # uploads of the whole buffer (one per capacity)
        self.tail_uploads = 0

    def n_alive(self) -> int:
        return sum(self.alive)

    # ------------------------------------------------------------ vectors

    def append_vector(self, v: np.ndarray) -> None:
        if self.count == self.vectors.shape[0]:
            cap = max(1024, 2 * self.count)
            grown = np.zeros((cap, self.dim), dtype=np.float32)
            grown[: self.count] = self.vectors[: self.count]
            self.vectors = grown
        self.vectors[self.count] = v
        self.count += 1

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device, copy=True)

    def device_scan(self, q: np.ndarray, mask: Optional[np.ndarray], m: int) -> np.ndarray:
        """Exact masked cosine scores of the top-M rows, computed on the
        device: a host (count,) array with -inf outside them. Only the
        rows appended since the last query are uploaded; mask=None means
        the alive rows, whose mask stays on the device."""
        cap = self.vectors.shape[0]
        if self.dev_buf is None or self.dev_buf.shape[0] != cap:
            self.dev_buf = self._upload(self.vectors)
            self.full_uploads += 1
            self.dev_rows = self.count
            self.dev_alive_rows = -1
        elif self.dev_rows < self.count:
            _tail_update(self.dev_buf, self._upload(self.vectors[self.dev_rows : self.count]), self.dev_rows)
            self.tail_uploads += 1
            self.dev_rows = self.count
        if mask is None:
            if self.dev_alive is None or self.dev_alive_rows != self.count or self.dev_alive.shape[0] != cap:
                mfull = np.zeros(cap, np.float32)
                mfull[: self.count] = np.asarray(self.alive, dtype=np.float32)
                self.dev_alive = self._upload(mfull)
                self.dev_alive_rows = self.count
            m_dev = self.dev_alive
        else:
            mfull = np.zeros(cap, np.float32)
            mfull[: self.count] = mask
            m_dev = self._upload(mfull)
        v, i = _masked_topm(self.dev_buf, self._upload(q), m_dev, min(m, cap))
        v, i = v.cpu().numpy(), i.cpu().numpy()
        out = np.full(self.count, -np.inf, dtype=np.float32)
        ok = np.isfinite(v) & (i < self.count)
        out[i[ok]] = v[ok]
        return out

    # ------------------------------------------------------------- lexical

    def add_lexical(self, text: str, row: int) -> None:
        toks = Counter(_TOKEN_RE.findall(text.lower()))
        self.tf.append(toks)
        for t in toks:
            self.df[t] += 1
            self.postings.setdefault(t, []).append(row)
        self.total_len += sum(toks.values())

    def drop_lexical(self, row: int) -> None:
        toks = self.tf[row]
        for t in toks:
            self.df[t] -= 1
            if self.df[t] <= 0:
                del self.df[t]
        self.total_len -= sum(toks.values())

    def bm25_candidates(self, query: str, mask: np.ndarray) -> Dict[int, float]:
        """Exact BM25 over the rows matching >= 1 query term (an
        inverted-index walk: O(matching rows), never O(corpus))."""
        n = self.n_alive()
        if n == 0:
            return {}
        avg_len = max(self.total_len / n, 1.0)
        idf = {}
        rows: set = set()
        for t in set(_TOKEN_RE.findall(query.lower())):
            dft = self.df.get(t, 0)
            if dft:
                idf[t] = math.log(1.0 + (n - dft + 0.5) / (dft + 0.5))
                rows.update(self.postings.get(t, ()))
        scores: Dict[int, float] = {}
        for i in rows:
            if not mask[i]:
                continue
            tfs = self.tf[i]
            dl = sum(tfs.values())
            s = 0.0
            for t, w in idf.items():
                f = tfs.get(t, 0)
                if f:
                    s += w * (f * (_BM25_K1 + 1)) / (f + _BM25_K1 * (1 - _BM25_B + _BM25_B * dl / avg_len))
            if s:
                scores[i] = s
        return scores


class TextVectorStore(BaseVectorStore):
    """Text chunks with their single-vector embeddings, scanned on
    `device` (the card unless the caller passes `device="cpu"`) past
    `DEVICE_SCAN_MIN_ROWS` rows; persisted under `path` by `save()`."""

    def __init__(self, path: Optional[str | Path] = None, hybrid_lexical: bool = True, device=None):
        self.path = Path(path) if path else None
        self.hybrid_lexical = hybrid_lexical
        self.device = torch.device(device) if device is not None else default_device()
        self._ns_map: Dict[str, _Namespace] = {}
        self._lock = threading.RLock()
        if self.path and self.path.exists():
            self._load()

    def _ns(self, app_id: Optional[str]) -> _Namespace:
        key = app_id or _DEFAULT_NS
        if key not in self._ns_map:
            self._ns_map[key] = _Namespace(self.device)
        return self._ns_map[key]

    async def initialize(self) -> bool:
        return True

    async def store_embeddings(
        self, chunks: List[DocumentChunk], app_id: Optional[str] = None
    ) -> Tuple[bool, List[str], Dict[str, Any]]:
        if not chunks:
            return True, [], {}
        ns = self._ns(app_id)
        ids = []
        with self._lock:
            vecs = [np.asarray(c.embedding, dtype=np.float32).reshape(-1) for c in chunks]
            if ns.dim is None:
                ns.dim = vecs[0].shape[0]
                ns.vectors = np.zeros((0, ns.dim), dtype=np.float32)
            for c, v in zip(chunks, vecs):
                sid = f"{c.document_id}-{c.chunk_number}"
                old = ns._id_to_row.get(sid)
                if old is not None and ns.alive[old]:  # an upsert retires the old row
                    ns.alive[old] = False
                    ns.drop_lexical(old)
                    ns.dev_alive_rows = -1
                row = len(ns.rows)
                ns.rows.append(DocumentChunk(document_id=c.document_id, chunk_number=c.chunk_number,
                                             content=c.content, embedding=[], metadata=c.metadata))
                ns.alive.append(True)
                ns.add_lexical(c.content or "", row)
                ns._id_to_row[sid] = row
                n = float(np.linalg.norm(v))
                ns.append_vector(v / n if n else v)
                ids.append(sid)
        return True, ids, {"vector_store_backend": "torch_text", "vector_store_rows": len(chunks)}

    async def query_similar(
        self,
        query_embedding: Union[np.ndarray, List[float]],
        k: int,
        doc_ids: Optional[Sequence[str]] = None,
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
        query_text: Optional[str] = None,
    ) -> List[DocumentChunk]:
        ns = self._ns(app_id)
        if not ns.rows:
            return []
        q = np.asarray(query_embedding, dtype=np.float32).reshape(-1)
        qn = np.linalg.norm(q)
        if qn:
            q = q / qn
        mask = np.array(ns.alive, dtype=bool)
        if doc_ids is not None:
            allowed = set(doc_ids)
            mask &= np.array([r.document_id in allowed for r in ns.rows], dtype=bool)
        if not mask.any():
            return []
        k = min(k, int(mask.sum()))
        # a small store scores on the host; a large one on the device,
        # which returns exact top-M scores with M sized so that the hybrid
        # merge stays exact (module doc)
        if ns.count < DEVICE_SCAN_MIN_ROWS:
            scores = ns.vectors[: ns.count] @ q
            scores = np.where(mask, scores, -np.inf).astype(np.float32)
        else:
            m = max(4 * k, 256)
            scores = ns.device_scan(q, None if doc_ids is None else mask.astype(np.float32), m)
        if self.hybrid_lexical and query_text:
            lex_map = ns.bm25_candidates(query_text, mask)
            if lex_map:
                peak = max(lex_map.values())
                # equal-weight hybrid; BM25 normalized per query so the
                # combined score stays cosine-scaled for min_score filters
                combined = np.where(np.isfinite(scores), 0.5 * scores, -np.inf)
                for i, s in lex_map.items():
                    cos = scores[i]
                    if not np.isfinite(cos):  # outside the device top-M: exact host dot
                        cos = float(ns.vectors[i] @ q)
                    combined[i] = 0.5 * cos + 0.5 * (s / peak)
                scores = combined
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        out = []
        for i in top:
            if not np.isfinite(scores[int(i)]):
                continue
            c = ns.rows[int(i)]
            out.append(DocumentChunk(document_id=c.document_id, chunk_number=c.chunk_number, content=c.content,
                                     embedding=[], metadata=c.metadata, score=float(scores[int(i)])))
        return out

    async def get_chunks_by_id(
        self,
        chunk_identifiers: Sequence[Tuple[str, int]],
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        ns = self._ns(app_id)
        out = []
        for doc_id, num in chunk_identifiers:
            row = ns._id_to_row.get(f"{doc_id}-{num}")
            if row is not None and ns.alive[row]:
                out.append(ns.rows[row])
        return out

    async def delete_chunks_by_document_id(self, document_id: str, app_id: Optional[str] = None) -> bool:
        ns = self._ns(app_id)
        with self._lock:
            for i, r in enumerate(ns.rows):
                if r.document_id == document_id and ns.alive[i]:
                    ns.alive[i] = False
                    ns.drop_lexical(i)
                    ns._id_to_row.pop(f"{r.document_id}-{r.chunk_number}", None)
                    ns.dev_alive_rows = -1
        return True

    # ------------------------------------------------------------- persist

    def save(self) -> None:
        if not self.path:
            return
        self.path.mkdir(parents=True, exist_ok=True)
        for key, ns in self._ns_map.items():
            np.save(self.path / f"{key}.vectors.npy", ns.vectors[: ns.count])
            with open(self.path / f"{key}.rows.json", "w") as f:
                json.dump({"alive": ns.alive, "rows": [r.model_dump(exclude={"embedding"}) for r in ns.rows]}, f)

    def _load(self) -> None:
        for vec_file in self.path.glob("*.vectors.npy"):
            key = vec_file.name[: -len(".vectors.npy")]
            rows_file = self.path / f"{key}.rows.json"
            if not rows_file.exists():
                continue
            ns = _Namespace(self.device)
            ns.vectors = np.ascontiguousarray(np.load(vec_file), dtype=np.float32)
            ns.count = ns.vectors.shape[0]
            ns.dim = ns.vectors.shape[1] if ns.vectors.size else None
            with open(rows_file) as f:
                data = json.load(f)
            ns.alive = data["alive"]
            for i, rd in enumerate(data["rows"]):
                rd["embedding"] = []
                c = DocumentChunk(**rd)
                ns.rows.append(c)
                if ns.alive[i]:
                    ns._id_to_row[f"{c.document_id}-{c.chunk_number}"] = i
                    ns.add_lexical(c.content or "", i)
                else:
                    ns.tf.append(Counter())
            self._ns_map[key] = ns
