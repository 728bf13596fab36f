"""Abstract embedding interface: copy of
`morphik_core_tpu/embedding/base_embedding_model.py`."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Union

import numpy as np

from morphik_core_tpu_torch.models.schemas import Chunk


class BaseEmbeddingModel(ABC):
    @abstractmethod
    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        """Chunks -> one embedding per chunk (multivector (n, d) for
        late-interaction models, vector (d,) for single-vector models)."""

    @abstractmethod
    async def embed_for_query(self, text: str) -> np.ndarray:
        """Query text -> embedding."""
