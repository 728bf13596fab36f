"""Single-vector text embedding for the text index: port of
`morphik_core_tpu/embedding/text_embedding.py::HashingEmbeddingModel`
(`:35-62`), a deterministic offline feature-hashing embedder (no network,
no weights), bit-identical to the reference's.

Not ported yet (ROADMAP Queue 1 item 3g): `RoutedEmbeddingModel` and
`OpenAICompatEmbeddingModel`, which call an embedding endpoint;
`build_services` refuses an `embedding.model` of `registered_models`.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Union

import numpy as np

from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.models.schemas import Chunk

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashingEmbeddingModel(BaseEmbeddingModel):
    """Unigrams + bigrams hashed into `dim` buckets with sign hashing
    (blake2b, 8 bytes), sublinear tf, L2 norm."""

    def __init__(self, dim: int = 768):
        self.dim = dim

    def _embed(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        toks = _TOKEN_RE.findall(text.lower())
        grams = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        for g in grams:
            h = int.from_bytes(hashlib.blake2b(g.encode(), digest_size=8).digest(), "little")
            v[h % self.dim] += 1.0 if (h >> 63) & 1 else -1.0
        v = np.sign(v) * np.log1p(np.abs(v))
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        if isinstance(chunks, Chunk):
            chunks = [chunks]
        return [self._embed(c.content) for c in chunks]

    async def embed_for_query(self, text: str) -> np.ndarray:
        return self._embed(text)
