"""Vector store interface: copy of `morphik_core_tpu/vector_store/base_vector_store.py`."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from morphik_core_tpu_torch.models.schemas import DocumentChunk


class BaseVectorStore(ABC):
    @abstractmethod
    async def store_embeddings(
        self, chunks: List[DocumentChunk], app_id: Optional[str] = None
    ) -> Tuple[bool, List[str], Dict[str, Any]]:
        """Store chunks (with .embedding set). Returns (ok, stored ids, metrics)."""

    @abstractmethod
    async def query_similar(
        self,
        query_embedding: Union[np.ndarray, List[float]],
        k: int,
        doc_ids: Optional[Sequence[str]] = None,
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        ...

    @abstractmethod
    async def get_chunks_by_id(
        self,
        chunk_identifiers: Sequence[Tuple[str, int]],
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        ...

    @abstractmethod
    async def delete_chunks_by_document_id(self, document_id: str, app_id: Optional[str] = None) -> bool:
        ...
