"""Rerankers for the text retrieval path: port of
`morphik_core_tpu/reranker/rerankers.py` (`BaseReranker`,
`OverlapReranker`, `build_reranker(None)`, `ColQwenReranker`).

  - OverlapReranker: a deterministic lexical scorer (token overlap with
    idf weighting), the reranker when no ColQwen tower is in process.
  - ColQwenReranker: embeds the query and the chunk texts with the
    ColQwen text tower already on the card and scores them with exact
    MaxSim, K2 (`ops/maxsim.py::maxsim`) over the f32 chunk tokens.
    `use_kernel=False` (`tpu.use_pallas=false`) runs K2's plain version
    on the same device instead. The reference hard-codes its XLA
    MaxSim here (`use_pallas=False`); the scores are the same function,
    within f32 rounding.

Not ported yet (ROADMAP Queue 1 item 3g): `CrossEncoderReranker`, which
needs sentence-transformers and its weights; `build_reranker` takes no
model name.
"""

from __future__ import annotations

import asyncio
import math
import re
from abc import ABC, abstractmethod
from typing import List, Sequence, Union

import numpy as np
import torch

from morphik_core_tpu_torch.models.schemas import DocumentChunk
from morphik_core_tpu_torch.ops.maxsim import maxsim_scores, pad_multivectors


class BaseReranker(ABC):
    @abstractmethod
    async def rerank(self, query: str, chunks: List[DocumentChunk]) -> List[DocumentChunk]:
        """Rescore chunks against the query; returns chunks sorted desc."""

    @abstractmethod
    async def compute_score(self, query: str, texts: Union[str, List[str]]) -> Union[float, List[float]]:
        ...


def _rerank_by(chunks: List[DocumentChunk], scores: Sequence[float]) -> List[DocumentChunk]:
    for c, s in zip(chunks, scores):
        c.score = float(s)
    return sorted(chunks, key=lambda c: -c.score)


_TOK = re.compile(r"[a-z0-9]+")


class OverlapReranker(BaseReranker):
    def _scores(self, query: str, texts: Sequence[str]) -> List[float]:
        q = _TOK.findall(query.lower())
        if not q or not texts:
            return [0.0] * len(texts)
        docs = [_TOK.findall(t.lower()) for t in texts]
        n = len(docs)
        df = {}
        for d in docs:
            for w in set(d):
                df[w] = df.get(w, 0) + 1
        out = []
        for d in docs:
            counts = {}
            for w in d:
                counts[w] = counts.get(w, 0) + 1
            s = 0.0
            for w in q:
                if w in counts:
                    idf = math.log(1 + n / df.get(w, 1))
                    tf = counts[w] / (counts[w] + 1.5)
                    s += idf * tf
            out.append(s / (math.sqrt(len(q)) or 1.0))
        return out

    async def rerank(self, query: str, chunks: List[DocumentChunk]) -> List[DocumentChunk]:
        return _rerank_by(chunks, self._scores(query, [c.content for c in chunks]))

    async def compute_score(self, query: str, texts: Union[str, List[str]]) -> Union[float, List[float]]:
        single = isinstance(texts, str)
        scores = self._scores(query, [texts] if single else list(texts))
        return scores[0] if single else scores


def build_reranker(model_name=None) -> BaseReranker:
    """The lexical reranker (the port has no cross-encoder)."""
    if model_name:
        raise NotImplementedError(
            f"not ported: the cross-encoder reranker {model_name!r} (ROADMAP Queue 1 item 3g)"
        )
    return OverlapReranker()


class ColQwenReranker(BaseReranker):
    """Late-interaction reranker on the ColQwen model the embedder already
    holds on the device: no second model, no extra weights."""

    def __init__(self, colpali_embedding_model, batch_size: int = 16, use_kernel: bool = True):
        self.embedding_model = colpali_embedding_model
        self.batch_size = batch_size
        self.use_kernel = use_kernel

    async def compute_score(self, query: str, texts: Union[str, List[str]]) -> Union[float, List[float]]:
        single = isinstance(texts, str)
        items = [texts] if single else list(texts)
        if not items:
            return []
        q = await self.embedding_model.embed_for_query(query)
        # the tower and the scoring run in a worker thread: the event loop serves meanwhile
        out = await asyncio.to_thread(self._score, q, items)
        return out[0] if single else out

    def _score(self, q: np.ndarray, items: List[str]) -> List[float]:
        model = self.embedding_model.model
        mvs: List[np.ndarray] = []
        for s in range(0, len(items), self.batch_size):
            mvs.extend(model.embed_queries(items[s : s + self.batch_size]))
        dense, mask = pad_multivectors(mvs)
        dev = model.device
        scores = maxsim_scores(q, torch.from_numpy(dense).to(dev), torch.from_numpy(mask).to(dev),
                               use_kernel=self.use_kernel)
        return [float(v) for v in scores.cpu().numpy()]

    async def rerank(self, query: str, chunks: List[DocumentChunk]) -> List[DocumentChunk]:
        if not chunks:
            return chunks
        return _rerank_by(chunks, await self.compute_score(query, [c.content for c in chunks]))
