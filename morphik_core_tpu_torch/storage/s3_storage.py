"""S3-compatible object storage: port of `morphik_core_tpu/storage/s3_storage.py`.

boto3 is imported when the storage is built, never when this module is
imported: neither machine has it, and construction without it raises
the reference's `RuntimeError`. Its calls block, so each runs in a worker
thread; uploads are bounded by a semaphore of `upload_concurrency`.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Tuple

from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.utils.fast_ops import decode_base64

logger = logging.getLogger(__name__)


class S3Storage(BaseStorage):
    def __init__(
        self,
        default_bucket: str,
        region_name: Optional[str] = None,
        endpoint_url: Optional[str] = None,
        aws_access_key_id: Optional[str] = None,
        aws_secret_access_key: Optional[str] = None,
        upload_concurrency: int = 8,
    ):
        try:
            import boto3  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError("S3Storage requires boto3; install it or use storage.provider='local'") from e
        self._client = boto3.client(
            "s3",
            region_name=region_name,
            endpoint_url=endpoint_url,
            aws_access_key_id=aws_access_key_id,
            aws_secret_access_key=aws_secret_access_key,
        )
        self.default_bucket = default_bucket
        self._upload_sem = asyncio.Semaphore(upload_concurrency)

    def _bucket(self, bucket: str) -> str:
        return bucket or self.default_bucket

    async def upload_file(self, file: bytes, key: str, content_type: Optional[str] = None,
                          bucket: str = "") -> Tuple[str, str]:
        b = self._bucket(bucket)
        extra = {"ContentType": content_type} if content_type else {}
        async with self._upload_sem:
            await asyncio.to_thread(self._client.put_object, Bucket=b, Key=key, Body=file, **extra)
        return b, key

    async def upload_from_base64(self, content: str, key: str, content_type: Optional[str] = None,
                                 bucket: str = "") -> Tuple[str, str]:
        return await self.upload_file(decode_base64(content), key, content_type, bucket)

    async def download_file(self, bucket: str, key: str) -> bytes:
        def _get() -> bytes:
            return self._client.get_object(Bucket=self._bucket(bucket), Key=key)["Body"].read()

        return await asyncio.to_thread(_get)

    async def get_download_url(self, bucket: str, key: str, expires_in: int = 3600) -> str:
        return await asyncio.to_thread(
            self._client.generate_presigned_url, "get_object",
            Params={"Bucket": self._bucket(bucket), "Key": key}, ExpiresIn=expires_in,
        )

    async def delete_file(self, bucket: str, key: str) -> bool:
        try:
            await asyncio.to_thread(self._client.delete_object, Bucket=self._bucket(bucket), Key=key)
            return True
        except Exception:  # noqa: BLE001 — the reference reports a failed delete as False
            logger.exception("s3 delete failed: %s/%s", bucket, key)
            return False

    async def get_object_size(self, bucket: str, key: str) -> Optional[int]:
        try:
            resp = await asyncio.to_thread(self._client.head_object, Bucket=self._bucket(bucket), Key=key)
            return int(resp["ContentLength"])
        except Exception:  # noqa: BLE001 — a missing object (or any failed HEAD) has no size, as in the reference
            return None

    async def list_objects(self, bucket: str, prefix: str = "") -> list:
        def _list():
            out = []
            paginator = self._client.get_paginator("list_objects_v2")
            for page in paginator.paginate(Bucket=self._bucket(bucket), Prefix=prefix):
                for obj in page.get("Contents", []):
                    out.append((obj["Key"], int(obj["Size"])))
            return sorted(out)

        return await asyncio.to_thread(_list)
