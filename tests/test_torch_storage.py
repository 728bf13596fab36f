"""The port's disk cache and S3 storage against the JAX package's, on the CPU.

- `FileCacheManager`: the same puts and gets give the same hits, misses,
  evictions and byte totals in both packages (LRU order, the oversized
  item, a restart, the atomic put whose `.tmp` the restart skips, path
  escapes refused).
- `CachedStorage`: write-through on upload, cache-first on read, the
  cache invalidated on delete.
- `S3Storage` over a stub `boto3` (neither machine has boto3): both
  packages make the same client calls and return the same results;
  without boto3 both raise the same RuntimeError. `build_storage` wraps
  S3 in the cache when `storage.cache_enabled` is set, and a port
  server on cached S3 answers `/health`'s storage probe.
"""

import asyncio
import json
import sys
import threading
import types
import urllib.request
from pathlib import Path

import pytest

from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.services_init import build_storage as j_build_storage
from morphik_core_tpu.storage import cache_manager as j_cache
from morphik_core_tpu.storage import s3_storage as j_s3
from morphik_core_tpu.storage.local_storage import LocalStorage as JLocal
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.services_init import build_services, build_storage
from morphik_core_tpu_torch.storage import cache_manager as t_cache
from morphik_core_tpu_torch.storage import s3_storage as t_s3
from morphik_core_tpu_torch.storage.local_storage import LocalStorage as TLocal
from morphik_core_tpu_torch.utils.fast_ops import encode_base64

PKGS = {"torch": (t_cache, t_s3, TLocal), "jax": (j_cache, j_s3, JLocal)}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------------ cache


def _cache_lru(cache_mod, root):
    c = cache_mod.FileCacheManager(root, max_bytes=100)
    c.put("b", "k1", b"x" * 40)
    c.put("b", "k2", b"y" * 40)
    out = [c.get("b", "k1")]
    c.put("b", "k3", b"z" * 40)  # k2 is least recently used: evicted
    out += [c.get("b", "k2"), c.get("b", "k1"), c.get("b", "k3"), c.total_bytes, c.hits, c.misses]
    return out


def _cache_oversized(cache_mod, root):
    c = cache_mod.FileCacheManager(root, max_bytes=10)
    c.put("b", "big", b"x" * 50)
    return [c.get("b", "big"), c.total_bytes, sorted(p.name for p in Path(root).rglob("*"))]


def _cache_restart(cache_mod, root):
    c1 = cache_mod.FileCacheManager(root, max_bytes=1000)
    c1.put("b", "k", b"persisted")
    c1.put("", "top", b"level")
    (Path(root) / "b" / "junk.tmp").write_bytes(b"partial")  # a write cut short
    c2 = cache_mod.FileCacheManager(root, max_bytes=1000)
    return [c2.get("b", "k"), c2.get("", "top"), c2.get("b", "junk.tmp"), c2.total_bytes,
            sorted(p.name for p in Path(root).rglob("*.tmp"))]


def _cache_escape(cache_mod, root):
    (Path(root).parent / (Path(root).name + "-secrets")).mkdir(parents=True)
    c = cache_mod.FileCacheManager(root, max_bytes=1000)
    out = []
    for bucket, key in (("b", "../../etc/passwd"), ("", f"../{Path(root).name}-secrets/leak"), ("", "../x")):
        try:
            c.put(bucket, key, b"nope")
            out.append("stored")
        except ValueError as e:
            out.append(str(e))
    c.put("", "fine", b"ok")
    out += [c.get("", "fine"), (Path(root).parent / (Path(root).name + "-secrets") / "leak").exists()]
    return out


def _cache_invalidate(cache_mod, root):
    c = cache_mod.FileCacheManager(root, max_bytes=1000)
    c.put("b", "a/b.bin", b"12345")
    c.put("b", "a/b.bin", b"123")  # a re-put counts its bytes once
    total = c.total_bytes
    c.invalidate("b", "a/b.bin")
    c.invalidate("b", "never")
    return [total, c.total_bytes, c.get("b", "a/b.bin"), (Path(root) / "b" / "a" / "b.bin").exists()]


CACHE_CASES = {"lru": _cache_lru, "oversized": _cache_oversized, "restart": _cache_restart,
               "escape": _cache_escape, "invalidate": _cache_invalidate}


def _plain(x):
    return json.loads(json.dumps(x, default=lambda v: v.decode("latin-1") if isinstance(v, bytes) else str(v)))


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_matches_reference(case, tmp_path):
    got = {name: _plain(CACHE_CASES[case](mods[0], tmp_path / name / "cache")) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    if case == "lru":
        assert got["torch"][:4] == ["x" * 40, None, "x" * 40, "z" * 40] and got["torch"][4] <= 100
    elif case == "restart":
        assert got["torch"][:4] == ["persisted", "level", None, len("persisted") + len("level")]
    elif case == "escape":
        assert all(v.startswith("cache key escapes root") for v in got["torch"][:3])
        assert got["torch"][3:] == ["ok", False]


def test_cache_concurrent_puts_keep_the_byte_total(tmp_path):
    """Threads putting and reading at once: the byte total stays the sum of
    what is on disk, within the budget."""
    c = t_cache.FileCacheManager(tmp_path / "cache", max_bytes=4000)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(60):
                c.put("b", f"k{(t * 7 + i) % 23}", bytes([t]) * (50 + (i * 13) % 200))
                c.get("b", f"k{i % 23}")

        threads = [threading.Thread(target=work, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    on_disk = sum(p.stat().st_size for p in (tmp_path / "cache").rglob("*") if p.is_file())
    assert c.total_bytes == on_disk <= 4000


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cached_storage_write_through_and_hit(pkg, tmp_path):
    cache_mod, _, Local = PKGS[pkg]

    class Counting(Local):
        downloads = 0

        async def download_file(self, bucket, key):
            type(self).downloads += 1
            return await super().download_file(bucket, key)

    inner = Counting(tmp_path / "store")
    cache = cache_mod.FileCacheManager(tmp_path / "cache", max_bytes=1 << 20)
    s = cache_mod.CachedStorage(inner, cache)

    async def go():
        out = [await s.upload_file(b"hello", "a/b.txt", bucket="bk")]
        out += [await s.download_file("bk", "a/b.txt"), Counting.downloads]  # from the write-through copy
        cache.invalidate("bk", "a/b.txt")
        out += [await s.download_file("bk", "a/b.txt"), Counting.downloads]  # a miss: the inner store
        out += [await s.download_file("bk", "a/b.txt"), Counting.downloads]  # cached again
        out += [await s.upload_from_base64(encode_base64(b"b64"), "c.bin", bucket="bk"),
                cache.get("bk", "c.bin"), await s.get_object_size("bk", "c.bin"),
                await s.list_objects("bk"), await s.delete_file("bk", "a/b.txt"), cache.get("bk", "a/b.txt")]
        return out

    got = _run(go())
    assert got == [("bk", "a/b.txt"), b"hello", 0, b"hello", 1, b"hello", 1, ("bk", "c.bin"), b"b64", 3,
                   [("a/b.txt", 5), ("c.bin", 3)], True, None]


# --------------------------------------------------------------------- S3


class _StubS3:
    """boto3's S3 client as far as the storage calls it, in memory; every
    call recorded."""

    def __init__(self, kwargs):
        self.kwargs = kwargs
        self.calls = []
        self.data = {}

    def _record(self, method, **kw):
        self.calls.append((method, {k: (v if not isinstance(v, bytes) else f"<{len(v)} bytes>") for k, v in kw.items()}))

    def put_object(self, Bucket, Key, Body, **kw):
        self._record("put_object", Bucket=Bucket, Key=Key, Body=Body, **kw)
        self.data[(Bucket, Key)] = Body

    def get_object(self, Bucket, Key):
        self._record("get_object", Bucket=Bucket, Key=Key)
        body = self.data[(Bucket, Key)]
        return {"Body": types.SimpleNamespace(read=lambda: body)}

    def generate_presigned_url(self, op, Params, ExpiresIn):
        self._record("generate_presigned_url", op=op, Params=Params, ExpiresIn=ExpiresIn)
        return f"https://stub/{Params['Bucket']}/{Params['Key']}?exp={ExpiresIn}"

    def delete_object(self, Bucket, Key):
        self._record("delete_object", Bucket=Bucket, Key=Key)
        if Key == "locked":
            raise PermissionError("AccessDenied")
        self.data.pop((Bucket, Key), None)

    def head_object(self, Bucket, Key):
        self._record("head_object", Bucket=Bucket, Key=Key)
        if (Bucket, Key) not in self.data:
            raise KeyError(Key)
        return {"ContentLength": len(self.data[(Bucket, Key)])}

    def get_paginator(self, name):
        self._record("get_paginator", paginator=name)
        stub = self

        class Pages:
            def paginate(self, Bucket, Prefix):
                stub._record("paginate", Bucket=Bucket, Prefix=Prefix)
                keys = sorted((k, v) for (b, k), v in stub.data.items() if b == Bucket and k.startswith(Prefix))
                for i in range(0, len(keys), 2):  # two objects a page, in reverse: the storage sorts
                    yield {"Contents": [{"Key": k, "Size": len(v)} for k, v in reversed(keys[i : i + 2])]}
                yield {}

        return Pages()


@pytest.fixture()
def stub_boto3(monkeypatch):
    clients = []
    fake = types.ModuleType("boto3")

    def client(service, **kwargs):
        assert service == "s3"
        clients.append(_StubS3(kwargs))
        return clients[-1]

    fake.client = client
    monkeypatch.setitem(sys.modules, "boto3", fake)
    return clients


async def _s3_session(s3):
    out = [await s3.upload_file(b"payload", "a/b.bin", "application/octet-stream"),
           await s3.upload_file(b"x", "a/c.txt"),
           await s3.upload_from_base64(encode_base64(b"yy"), "d.txt", bucket="other"),
           await s3.download_file("", "a/b.bin"), await s3.download_file("other", "d.txt"),
           await s3.get_download_url("", "a/b.bin", expires_in=60),
           await s3.get_object_size("", "a/b.bin"), await s3.get_object_size("", "missing"),
           await s3.list_objects("", "a/"), await s3.list_objects("", ""),
           await s3.delete_file("", "a/b.bin"), await s3.delete_file("", "locked"),
           await s3.get_object_size("", "a/b.bin")]
    return out


def test_s3_storage_matches_reference(stub_boto3):
    got = {}
    for name, (_, s3_mod, _) in PKGS.items():
        s3 = s3_mod.S3Storage("default-bucket", region_name="eu-west-1", endpoint_url="http://minio:9000",
                              aws_access_key_id="AK", aws_secret_access_key="SK", upload_concurrency=2)
        got[name] = (_run(_s3_session(s3)), stub_boto3[-1].calls, stub_boto3[-1].kwargs)
    assert got["torch"] == got["jax"]
    results, calls, kwargs = got["torch"]
    assert kwargs == {"region_name": "eu-west-1", "endpoint_url": "http://minio:9000", "aws_access_key_id": "AK",
                      "aws_secret_access_key": "SK"}
    assert results == [("default-bucket", "a/b.bin"), ("default-bucket", "a/c.txt"), ("other", "d.txt"),
                       b"payload", b"yy", "https://stub/default-bucket/a/b.bin?exp=60", 7, None,
                       [("a/b.bin", 7), ("a/c.txt", 1)], [("a/b.bin", 7), ("a/c.txt", 1)], True, False, None]
    assert calls[0] == ("put_object", {"Bucket": "default-bucket", "Key": "a/b.bin", "Body": "<7 bytes>",
                                       "ContentType": "application/octet-stream"})
    assert calls[1] == ("put_object", {"Bucket": "default-bucket", "Key": "a/c.txt", "Body": "<1 bytes>"})


def test_s3_storage_without_boto3_raises_as_reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)  # absent: any import raises
    messages = []
    for _, s3_mod, _ in PKGS.values():
        with pytest.raises(RuntimeError, match="requires boto3") as e:
            s3_mod.S3Storage("bucket")
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _s3_settings(root: Path, cache_enabled: bool) -> dict:
    return {"storage": {"provider": "aws-s3", "bucket_name": "bk", "cache_enabled": cache_enabled,
                        "cache_path": str(root / "cache"), "cache_max_bytes": 1 << 20,
                        "storage_path": str(root / "s"), "region": "us-east-2", "upload_concurrency": 3}}


@pytest.mark.parametrize("cache_enabled", [True, False])
def test_build_storage_matches_reference(stub_boto3, tmp_path, monkeypatch, cache_enabled):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "env-ak")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "env-sk")
    raw = _s3_settings(tmp_path, cache_enabled)
    t = build_storage(Settings.from_dict(raw))
    j = j_build_storage(JSettings.model_validate(raw))
    assert type(t).__name__ == type(j).__name__ == ("CachedStorage" if cache_enabled else "S3Storage")
    assert stub_boto3[0].kwargs == stub_boto3[1].kwargs == {
        "region_name": "us-east-2", "endpoint_url": None, "aws_access_key_id": "env-ak",
        "aws_secret_access_key": "env-sk"}
    if cache_enabled:
        assert t.cache.max_bytes == j.cache.max_bytes == 1 << 20 and t.cache.root == j.cache.root
        t, j = t.inner, j.inner
    assert t.default_bucket == j.default_bucket == "bk" and t._upload_sem._value == j._upload_sem._value == 3
    local = {"storage": {"storage_path": str(tmp_path / "local")}}
    assert isinstance(build_storage(Settings.from_dict(local)), TLocal)
    assert isinstance(j_build_storage(JSettings.model_validate(local)), JLocal)


def test_server_on_cached_s3_ingests_and_reports_storage_health(stub_boto3, tmp_path):
    """A text-only port server on S3 behind the cache: an upload is written
    through to the bucket and the cache, its job reads the cached copy,
    and `/health`'s probe (`get_object_size` of `__health_probe__`) goes
    through the cache to S3."""
    raw = {**_s3_settings(tmp_path, True), "database": {"path": str(tmp_path / "db.sqlite")},
           "vector_store": {"index_path": str(tmp_path / "index")},
           "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
           "morphik": {"enable_colpali": False}}
    services = build_services(Settings.from_dict(raw), device="cpu")
    assert type(services.storage).__name__ == "CachedStorage"
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=60)

    try:
        on_loop(services.initialize())
        srv = HTTPServer(build_app(services), "127.0.0.1", 0)
        on_loop(srv.start())
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["components"]["storage"] == "ok", health
        client = stub_boto3[0]
        assert ("head_object", {"Bucket": "bk", "Key": "__health_probe__"}) in client.calls
        b = "s3-boundary"
        body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="n.txt"\r\n'
                "Content-Type: text/plain\r\n\r\n").encode() + b"the cached storage note" + f"\r\n--{b}--\r\n".encode()
        req = urllib.request.Request(base + "/ingest/file", data=body,
                                     headers={"Content-Type": f"multipart/form-data; boundary={b}"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            doc = json.loads(resp.read())
        key = f"ingest/{doc['external_id']}/n.txt"
        for _ in range(600):
            with urllib.request.urlopen(base + f"/documents/{doc['external_id']}/status", timeout=30) as resp:
                if json.loads(resp.read())["status"] == "completed":
                    break
        assert client.data[("bk", key)] == b"the cached storage note"
        assert services.storage.cache.get("bk", key) == b"the cached storage note"
        assert not any(c[0] == "get_object" for c in client.calls)  # the job read the write-through copy
        on_loop(srv.stop())
    finally:
        on_loop(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
