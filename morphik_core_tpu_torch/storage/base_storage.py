"""Storage abstraction: copy of `morphik_core_tpu/storage/base_storage.py`."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Tuple


class BaseStorage(ABC):
    @abstractmethod
    async def upload_file(self, file: bytes, key: str, content_type: Optional[str] = None, bucket: str = "") -> Tuple[str, str]:
        """Store bytes; returns (bucket, key)."""

    @abstractmethod
    async def upload_from_base64(self, content: str, key: str, content_type: Optional[str] = None, bucket: str = "") -> Tuple[str, str]:
        ...

    @abstractmethod
    async def download_file(self, bucket: str, key: str) -> bytes:
        ...

    @abstractmethod
    async def get_download_url(self, bucket: str, key: str, expires_in: int = 3600) -> str:
        ...

    @abstractmethod
    async def delete_file(self, bucket: str, key: str) -> bool:
        ...

    @abstractmethod
    async def get_object_size(self, bucket: str, key: str) -> Optional[int]:
        ...

    @abstractmethod
    async def list_objects(self, bucket: str, prefix: str = "") -> List[Tuple[str, int]]:
        """Enumerate (key, size_bytes) under `prefix`, sorted by key.

        Powers orphan-payload GC (scripts/check_completeness.py,
        scripts/purge_app.py) — the reference walks its Turbopuffer
        namespace / S3 prefix the same way (scripts/delete_namespace.py).
        """
