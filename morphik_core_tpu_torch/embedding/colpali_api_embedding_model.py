"""Multi-endpoint ColPali embedding client: port of
`morphik_core_tpu/embedding/colpali_api_embedding_model.py`.

An API node (`morphik.colpali_mode="api"`) loads no tower: it fans page
and query embedding out to N embedding servers, each a server that
speaks the `/embeddings` wire contract (the port's own, `api/app.py`):

  POST {endpoint}/embeddings  {"input_type": "image"|"text", "inputs": [...]}
  -> 200 npz bytes of arrays named emb_0..emb_{n-1}

Behaviours kept from the reference:
  - interleaved sharding: input i goes to the i % n-th usable endpoint;
  - per-endpoint health with a cooldown after which a down endpoint is
    probed again (`HEALTH_COOLDOWN_S`);
  - the inputs of a failed shard retried on the endpoints still
    standing; with none left, every health is reset and
    `AllEndpointsDown` raised;
  - HTTP 413 answered by halving the batch, recursively; a single input
    that still answers 413 raises `PayloadTooLarge` and leaves the
    endpoint's health alone.

The transport is `completion/_http.py::post_bytes` (urllib) in worker
threads. A query image is a decoded (H, W, 3) uint8 array (what
`document_service` hands it) sent as a PNG data URI of `encode_png`.
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from morphik_core_tpu_torch.completion._http import HTTPStatusError, post_bytes
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.models.schemas import Chunk
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.png import encode_png

logger = logging.getLogger(__name__)

HEALTH_COOLDOWN_S = 60.0


class PayloadTooLarge(Exception):
    pass


class AllEndpointsDown(Exception):
    pass


class _EndpointHealth:
    def __init__(self) -> None:
        self.healthy = True
        self.marked_down_at = 0.0

    def mark_down(self) -> None:
        self.healthy = False
        self.marked_down_at = time.time()

    def usable(self) -> bool:
        """A down endpoint is probed again once the cooldown has passed."""
        return self.healthy or (time.time() - self.marked_down_at) > HEALTH_COOLDOWN_S


class ColpaliApiEmbeddingModel(BaseEmbeddingModel):
    def __init__(
        self,
        endpoints: Sequence[str],
        *,
        embedding_dim: int = 128,
        timeout_s: float = 120.0,
        auth_token: Optional[str] = None,
    ):
        """`auth_token` is sent as a bearer: `services_init` passes
        `morphik.morphik_embedding_api_key`, the key a port or reference
        `/embeddings` route demands when one is configured."""
        if not endpoints:
            raise ValueError("at least one embedding endpoint is required")
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self._health: Dict[str, _EndpointHealth] = {e: _EndpointHealth() for e in self.endpoints}
        self._dim = embedding_dim
        self.timeout_s = timeout_s
        self.auth_token = auth_token
        self.last_metrics: Dict[str, float] = {}

    @property
    def embedding_dim(self) -> int:
        return self._dim

    # ------------------------------------------------------------- transport

    def _post_sync(self, endpoint: str, input_type: str, inputs: List[str]) -> List[np.ndarray]:
        body = json.dumps({"input_type": input_type, "inputs": inputs}).encode()
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        try:
            payload = post_bytes(f"{endpoint}/embeddings", body, headers, self.timeout_s)
        except HTTPStatusError as e:
            if e.status == 413:
                raise PayloadTooLarge(endpoint) from e
            raise
        npz = np.load(io.BytesIO(payload))  # allow_pickle=False: arrays only
        return [np.asarray(npz[f"emb_{i}"], dtype=np.float32) for i in range(len(inputs))]

    async def _post(self, endpoint: str, input_type: str, inputs: List[str]) -> List[np.ndarray]:
        """One endpoint call; 413 -> the batch split in half, recursively."""
        try:
            return await asyncio.to_thread(self._post_sync, endpoint, input_type, inputs)
        except PayloadTooLarge:
            if len(inputs) <= 1:
                raise
            mid = len(inputs) // 2
            left = await self._post(endpoint, input_type, inputs[:mid])
            right = await self._post(endpoint, input_type, inputs[mid:])
            return left + right

    # ------------------------------------------------------------ scheduling

    def _usable_endpoints(self) -> List[str]:
        return [e for e in self.endpoints if self._health[e].usable()]

    def _shard(self, n: int, endpoints: List[str]) -> List[List[int]]:
        """Interleaved assignment: input i -> endpoint i % len(endpoints)."""
        shards: List[List[int]] = [[] for _ in endpoints]
        for i in range(n):
            shards[i % len(endpoints)].append(i)
        return shards

    async def _embed_batch(self, input_type: str, inputs: List[str]) -> List[np.ndarray]:
        if not inputs:
            return []
        t0 = time.perf_counter()
        results: List[Optional[np.ndarray]] = [None] * len(inputs)
        pending = list(range(len(inputs)))

        while pending:
            endpoints = self._usable_endpoints()
            if not endpoints:
                # a full reset, so the next request probes every endpoint again
                for h in self._health.values():
                    h.healthy = True
                raise AllEndpointsDown(f"all {len(self.endpoints)} embedding endpoints failed")
            shards = self._shard(len(pending), endpoints)

            async def run_shard(ep: str, idxs: List[int]) -> Tuple[str, List[int], Optional[List[np.ndarray]]]:
                if not idxs:
                    return ep, idxs, []
                try:
                    embs = await self._post(ep, input_type, [inputs[pending[j]] for j in idxs])
                    self._health[ep].healthy = True
                    return ep, idxs, embs
                except PayloadTooLarge:
                    # one input too large even alone is the client's data, not the
                    # endpoint's fault: marking it down would cascade over the fleet
                    raise
                except Exception as e:  # noqa: BLE001 — any other failure: the endpoint is down, the shard retried
                    logger.warning("embedding endpoint %s failed: %s", ep, e)
                    self._health[ep].mark_down()
                    return ep, idxs, None

            outs = await asyncio.gather(*[run_shard(ep, idxs) for ep, idxs in zip(endpoints, shards)])
            still_pending: List[int] = []
            for _, idxs, embs in outs:
                if embs is None:
                    still_pending.extend(pending[j] for j in idxs)
                else:
                    for j, emb in zip(idxs, embs):
                        results[pending[j]] = emb
            pending = sorted(still_pending)

        self.last_metrics = {
            "api_total_s": time.perf_counter() - t0,
            "api_inputs": len(inputs),
            "api_endpoints": len(self.endpoints),
        }
        return results  # type: ignore[return-value]

    # -------------------------------------------------------------- interface

    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        """Chunks -> multivectors, chunk-aligned: image chunks (their
        `content`, a data URI) and text chunks go as two streams."""
        if isinstance(chunks, Chunk):
            chunks = [chunks]
        if not chunks:
            return []
        image_items = [(i, c.content) for i, c in enumerate(chunks) if c.metadata.get("is_image")]
        text_items = [(i, c.content) for i, c in enumerate(chunks) if not c.metadata.get("is_image")]
        results: List[Optional[np.ndarray]] = [None] * len(chunks)
        if image_items:
            embs = await self._embed_batch("image", [v for _, v in image_items])
            for (i, _), e in zip(image_items, embs):
                results[i] = e
        if text_items:
            embs = await self._embed_batch("text", [v for _, v in text_items])
            for (i, _), e in zip(text_items, embs):
                results[i] = e
        return results  # type: ignore[return-value]

    async def embed_for_query(self, query: Union[str, np.ndarray]) -> np.ndarray:
        """A text, or a decoded (H, W, 3) uint8 image sent as a PNG data URI."""
        if isinstance(query, np.ndarray):
            uri = bytes_to_data_uri(encode_png(query), "image/png")
            return (await self._embed_batch("image", [uri]))[0]
        return (await self._embed_batch("text", [query]))[0]
