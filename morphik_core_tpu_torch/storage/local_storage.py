"""Filesystem-backed storage: copy of `morphik_core_tpu/storage/local_storage.py`
(same on-disk layout: `{root}/{bucket}/{key}`)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.utils.fast_ops import decode_base64

logger = logging.getLogger(__name__)


class LocalStorage(BaseStorage):
    def __init__(self, storage_path: str | Path = "./storage"):
        self.root = Path(storage_path)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, bucket: str, key: str) -> Path:
        p = (self.root / bucket / key) if bucket else (self.root / key)
        resolved = p.resolve()
        root = self.root.resolve()
        # separator-aware containment: a bare startswith would accept
        # escapes into sibling dirs sharing the root's name as a prefix
        # ('./storage' vs './storage-secrets')
        if resolved != root and root not in resolved.parents:
            raise ValueError(f"storage key escapes root: {key}")
        return resolved

    async def upload_file(self, file: bytes, key: str, content_type: Optional[str] = None, bucket: str = "") -> Tuple[str, str]:
        p = self._path(bucket, key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(file)
        return bucket, key

    async def upload_from_base64(self, content: str, key: str, content_type: Optional[str] = None, bucket: str = "") -> Tuple[str, str]:
        return await self.upload_file(decode_base64(content), key, content_type, bucket)

    async def download_file(self, bucket: str, key: str) -> bytes:
        return self._path(bucket, key).read_bytes()

    async def get_download_url(self, bucket: str, key: str, expires_in: int = 3600) -> str:
        return f"file://{self._path(bucket, key)}"

    async def delete_file(self, bucket: str, key: str) -> bool:
        p = self._path(bucket, key)
        if p.exists():
            p.unlink()
            return True
        return False

    async def get_object_size(self, bucket: str, key: str) -> Optional[int]:
        p = self._path(bucket, key)
        return p.stat().st_size if p.exists() else None

    async def list_objects(self, bucket: str, prefix: str = "") -> list:
        base = (self.root / bucket) if bucket else self.root
        base = base.resolve()
        root = self.root.resolve()
        if base != root and root not in base.parents:
            raise ValueError(f"storage bucket escapes root: {bucket}")
        if not base.exists():
            return []
        out = []
        for p in base.rglob("*"):
            if not p.is_file():
                continue
            key = p.relative_to(base).as_posix()
            if key.startswith(prefix):
                out.append((key, p.stat().st_size))
        return sorted(out)
