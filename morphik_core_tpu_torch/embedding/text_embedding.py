"""Single-vector text embedding for the text index: port of
`morphik_core_tpu/embedding/text_embedding.py`.

  - HashingEmbeddingModel: a deterministic offline feature-hashing
    embedder (no network, no weights), bit-identical to the reference's;
    the text embedder when `embedding.model` is no registered key.
  - RoutedEmbeddingModel: a `registered_models` key routed to its
    provider (Ollama's native /api/embed, an Azure deployment with the
    `api-key` header, any OpenAI-compatible /embeddings otherwise), in
    batches of 5 for local hosts and 100 for hosted APIs, vectors cut to
    min(embedding.dimensions, 2000).
  - OpenAICompatEmbeddingModel: one OpenAI-compatible /embeddings endpoint.

The network calls go over the stdlib transport (`completion/_http.py`);
a 4xx/5xx answer raises.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Union

import numpy as np

from morphik_core_tpu_torch.completion._http import post_json
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


class OpenAICompatEmbeddingModel(BaseEmbeddingModel):
    """POST {base_url}/embeddings with {model, input: [...]}; vectors cut
    to `max_dims`."""

    def __init__(
        self,
        base_url: str,
        model: str,
        api_key: Optional[str] = None,
        batch_size: int = 100,
        max_dims: int = 2000,
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.batch_size = batch_size
        self.max_dims = max_dims
        self.timeout = timeout

    async def _post(self, inputs: List[str]) -> List[np.ndarray]:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        data = (await post_json(f"{self.base_url}/embeddings", {"model": self.model, "input": inputs}, headers,
                                self.timeout))["data"]
        return [np.asarray(d["embedding"], dtype=np.float32)[: self.max_dims] for d in data]

    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        if isinstance(chunks, Chunk):
            chunks = [chunks]
        texts = [c.content for c in chunks]
        out: List[np.ndarray] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(await self._post(texts[i : i + self.batch_size]))
        return out

    async def embed_for_query(self, text: str) -> np.ndarray:
        return (await self._post([text]))[0]


_LOCAL_HOSTS = ("localhost", "127.0.0.1", "host.docker.internal", ":11434")


class RoutedEmbeddingModel(BaseEmbeddingModel):
    """A `registered_models` entry routed by its model name:
    "ollama/x" -> POST {api_base}/api/embed; "azure/x" -> the deployment's
    /embeddings with an `api-key` header (api_base required); anything
    else -> OpenAI-compatible POST {api_base}/embeddings (default
    https://api.openai.com/v1), "openai/" stripped from the name."""

    def __init__(self, model_key: str, settings):
        if model_key not in settings.registered_models:
            raise ValueError(f"Model '{model_key}' not found in registered_models configuration")
        self.model_key = model_key
        self.model_config = dict(settings.registered_models[model_key])
        self.dimensions = min(settings.embedding.dimensions or 2000, 2000)
        name = str(self.model_config.get("model_name", model_key))
        base = str(self.model_config.get("api_base", "") or "")
        self._is_local = any(h in base.lower() for h in _LOCAL_HOSTS) or "ollama" in name.lower()
        self.batch_size = 5 if self._is_local else 100
        if name.startswith("ollama/"):
            self.provider, self.model_name = "ollama", name.split("/", 1)[1]
            self.api_base = (base or "http://localhost:11434").rstrip("/")
        elif name.startswith("azure/"):
            self.provider, self.model_name = "azure", name.split("/", 1)[1]
            if not base:
                raise ValueError(f"registered model {model_key!r}: azure/* requires api_base")
            self.api_base = base.rstrip("/")
            self.azure_api_version = str(self.model_config.get("api_version", "2024-02-01"))
        else:
            self.provider, self.model_name = "openai", name.removeprefix("openai/")
            self.api_base = (base or "https://api.openai.com/v1").rstrip("/")
        self.api_key = self.model_config.get("api_key")
        self.timeout = float(self.model_config.get("timeout", 30.0))

    async def _request(self, url: str, payload: dict, headers: dict) -> dict:
        """The transport seam (tests replace it)."""
        return await post_json(url, payload, headers, self.timeout)

    async def _embed_batch(self, texts: List[str]) -> List[np.ndarray]:
        headers = {"Content-Type": "application/json"}
        if self.provider == "ollama":
            data = await self._request(f"{self.api_base}/api/embed", {"model": self.model_name, "input": texts},
                                       headers)
            vecs = data["embeddings"]
        else:
            if self.api_key:
                if self.provider == "azure":
                    headers["api-key"] = self.api_key
                else:
                    headers["Authorization"] = f"Bearer {self.api_key}"
            if self.provider == "azure":
                url = (f"{self.api_base}/openai/deployments/{self.model_name}"
                       f"/embeddings?api-version={self.azure_api_version}")
                payload = {"input": texts}
            else:
                url = f"{self.api_base}/embeddings"
                payload = {"model": self.model_name, "input": texts}
            data = await self._request(url, payload, headers)
            vecs = [d["embedding"] for d in data["data"]]
        return [np.asarray(v, dtype=np.float32)[: self.dimensions] for v in vecs]

    async def embed_documents(self, texts: List[str]) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(await self._embed_batch(texts[i : i + self.batch_size]))
        return out

    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        if isinstance(chunks, Chunk):
            chunks = [chunks]
        return await self.embed_documents([c.content for c in chunks])

    async def embed_for_query(self, text: str) -> np.ndarray:
        return (await self.embed_documents([text]))[0]
