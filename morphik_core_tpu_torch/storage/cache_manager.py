"""Write-through local-disk LRU cache in front of object storage: port of
`morphik_core_tpu/storage/cache_manager.py`.

`FileCacheManager` keeps files under `{cache_path}/{bucket}/{key}` within
a byte budget, evicting the least recently used; `CachedStorage` wraps a
`BaseStorage` (S3 in `services_init.build_storage`): write-through on
upload, cache-first on read, invalidated on delete.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, Optional, Tuple

from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.utils.fast_ops import decode_base64

logger = logging.getLogger(__name__)


class FileCacheManager:
    """Disk LRU keyed by (bucket, key) with a byte budget.

    Access times are tracked in memory and seeded from file mtimes at
    start-up, so the eviction order survives a restart."""

    def __init__(self, cache_path: str | Path, max_bytes: int = 10 * 1024**3):
        self.root = Path(cache_path)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._sizes: Dict[Path, int] = {}
        self._atime: Dict[Path, float] = {}
        self._total = 0
        self.hits = 0
        self.misses = 0
        # resolved, so seeded keys match _path()'s lookups; a .tmp file is
        # a write cut short and never an entry
        for p in self.root.resolve().rglob("*"):
            if p.is_file() and not p.name.endswith(".tmp"):
                st = p.stat()
                self._sizes[p] = st.st_size
                self._atime[p] = st.st_mtime
                self._total += st.st_size

    def _path(self, bucket: str, key: str) -> Path:
        p = (self.root / bucket / key) if bucket else (self.root / key)
        resolved = p.resolve()
        root = self.root.resolve()
        # separator-aware containment: a bare startswith would accept
        # escapes into sibling dirs sharing the root's name as a prefix
        if resolved != root and root not in resolved.parents:
            raise ValueError(f"cache key escapes root: {key}")
        return resolved

    def get(self, bucket: str, key: str) -> Optional[bytes]:
        p = self._path(bucket, key)
        with self._lock:
            if p not in self._sizes:
                self.misses += 1
                return None
            self._atime[p] = time.time()
            self.hits += 1
        try:
            return p.read_bytes()
        except FileNotFoundError:
            with self._lock:
                self._total -= self._sizes.pop(p, 0)
                self._atime.pop(p, None)
            return None

    def put(self, bucket: str, key: str, data: bytes) -> None:
        if len(data) > self.max_bytes:
            return
        p = self._path(bucket, key)
        p.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish: a concurrent get() never reads a half-written
        # file, and a crash mid-write leaves only a .tmp the seed skips.
        # One .tmp per put, published under the lock: the reference's one
        # `{key}.tmp` lets two puts of a key race (one replace finds no file)
        tmp = p.with_name(f"{p.name}.{uuid.uuid4().hex}.tmp")
        tmp.write_bytes(data)
        with self._lock:
            tmp.replace(p)
            old = self._sizes.get(p, 0)
            self._sizes[p] = len(data)
            self._atime[p] = time.time()
            self._total += len(data) - old
            self._evict_locked()

    def invalidate(self, bucket: str, key: str) -> None:
        p = self._path(bucket, key)
        with self._lock:
            self._total -= self._sizes.pop(p, 0)
            self._atime.pop(p, None)
            p.unlink(missing_ok=True)

    def _evict_locked(self) -> None:
        while self._total > self.max_bytes and self._sizes:
            victim = min(self._atime, key=self._atime.get)
            self._total -= self._sizes.pop(victim, 0)
            self._atime.pop(victim, None)
            victim.unlink(missing_ok=True)
            logger.debug("cache evicted %s", victim)

    @property
    def total_bytes(self) -> int:
        return self._total


class CachedStorage(BaseStorage):
    """BaseStorage wrapper: write-through on upload, cache-first on read."""

    def __init__(self, inner: BaseStorage, cache: FileCacheManager):
        self.inner = inner
        self.cache = cache

    async def upload_file(self, file: bytes, key: str, content_type: Optional[str] = None,
                          bucket: str = "") -> Tuple[str, str]:
        bucket_out, key_out = await self.inner.upload_file(file, key, content_type, bucket)
        self.cache.put(bucket_out, key_out, file)
        return bucket_out, key_out

    async def upload_from_base64(self, content: str, key: str, content_type: Optional[str] = None,
                                 bucket: str = "") -> Tuple[str, str]:
        return await self.upload_file(decode_base64(content), key, content_type, bucket)

    async def download_file(self, bucket: str, key: str) -> bytes:
        cached = self.cache.get(bucket, key)
        if cached is not None:
            return cached
        data = await self.inner.download_file(bucket, key)
        self.cache.put(bucket, key, data)
        return data

    async def get_download_url(self, bucket: str, key: str, expires_in: int = 3600) -> str:
        return await self.inner.get_download_url(bucket, key, expires_in)

    async def delete_file(self, bucket: str, key: str) -> bool:
        self.cache.invalidate(bucket, key)
        return await self.inner.delete_file(bucket, key)

    async def get_object_size(self, bucket: str, key: str) -> Optional[int]:
        return await self.inner.get_object_size(bucket, key)

    async def list_objects(self, bucket: str, prefix: str = ""):
        return await self.inner.list_objects(bucket, prefix)
