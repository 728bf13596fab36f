"""The repo's Python SDK (`sdks/python`) against the port's server on the
CPU: the folder, document, summary, app, migrate, logs and v2 tests of
`tests/test_sdk.py` run here unchanged on a port server (imported, so
they stay one body), and the parts of its two mixed tests that the port
serves are mirrored, the on-the-fly query (`query_document`) included;
only the connectors answer 501 (ROADMAP Queue 1 item 3d-ii)."""

import asyncio
import threading

import httpx
import pytest
import torch

from conftest import run_once
from test_sdk import (  # noqa: F401  (collected here, against this module's server_url)
    test_async_folder_and_user_scope,
    test_sdk_folder_objects_and_user_scope,
    test_sdk_grouped_and_folder_ops,
    test_sdk_ingest_directory_pattern,
    test_sdk_streaming_and_folders,
    test_sdk_v2_pipeline,
)
from morphik_tpu_sdk import AsyncMorphik, Morphik

from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.services_init import build_services

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server_url(tmp_path_factory):
    """The port's server on the CPU (development mode: the tiny random
    model), on a background event loop."""
    root = tmp_path_factory.mktemp("torch_sdk")
    settings = Settings.from_dict({
        "storage": {"storage_path": str(root / "storage")},
        "database": {"path": str(root / "db.sqlite")},
        "vector_store": {"index_path": str(root / "index"), "fde_num_repetitions": 4,
                         "fde_num_simhash_projections": 3, "fde_projection_dimension": 8},
        "telemetry": {"telemetry_dir": str(root / "logs" / "telemetry")},
    })
    services = build_services(settings, device="cpu")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    on_loop(services.initialize())
    srv = HTTPServer(build_app(services), "127.0.0.1", 0)
    on_loop(srv.start())
    yield f"http://127.0.0.1:{srv.port}"
    on_loop(srv.stop())
    on_loop(services.shutdown())
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)
    loop.close()


def test_sdk_new_surface_served_by_the_port(server_url):
    """`test_sdk.py::test_sdk_new_surface` without the connectors, which
    answer 501 here."""
    db = Morphik(base_url=server_url)
    out = db.query_document(b"The relay closes at 7 volts.", "What voltage closes the relay?", filename="spec.txt")
    assert out["completion"]
    doc = db.ingest_text("summary target", filename="st.txt", use_colpali=False)
    s = db.set_document_summary(doc.external_id, "short summary")
    assert s["version"] == 1
    assert db.get_document_summary(doc.external_id)["content"] == "short summary"
    assert isinstance(db.get_folder_summaries(), list)

    uri = db.generate_cloud_uri("sdkapp")
    assert uri["uri"].startswith("morphik://sdkapp:")
    apps = db.list_apps()
    assert any(a["app_id"] == uri["app_id"] for a in apps["apps"])
    rot = db.rotate_app_token(uri["app_id"])
    assert rot["token_version"] == 2

    m = db.migrate_document(b"migrated body", "sdk-legacy-1", filename="m.txt", use_colpali=False)
    assert m["status"] == "created" and m["document"]["external_id"] == "sdk-legacy-1"
    logs = db.get_logs()
    assert "events" in logs

    with pytest.raises(httpx.HTTPStatusError) as e:
        db.connector_auth_status("local")
    assert e.value.response.status_code == 501
    db.close()


def test_async_sdk_parity_served_by_the_port(server_url):
    """`test_sdk.py::test_async_sdk_parity` without the connectors."""

    async def go():
        async with AsyncMorphik(base_url=server_url) as db:
            assert (await db.ping())["status"] == "ok"
            doc = await db.ingest_file(b"Async ingested body: antimatter ratio 3:1.", filename="a.txt",
                                       use_colpali=False, wait=True)
            assert doc.system_metadata["status"] == "completed"
            chunks = await db.retrieve_chunks("antimatter ratio", k=1, use_colpali=False)
            assert chunks and "3:1" in chunks[0].content
            assert await db.list_documents(limit=5)
            out = await db.query_document(b"Core temp is 9 kilokelvin.", "What is the core temp?", filename="c.txt")
            assert out["completion"]
            s = await db.set_document_summary(doc.external_id, "async summary")
            assert s["version"] == 1
            assert (await db.get_document_summary(doc.external_id))["content"] == "async summary"
            uri = await db.generate_cloud_uri("asyncapp")
            assert uri["uri"].startswith("morphik://asyncapp:")
            toks = [tok async for tok in db.query_stream("antimatter", k=1, use_colpali=False)]
            assert toks

    run_once(go())


def test_sdk_folder_scoped_colpali_retrieve(server_url):
    """A folder handle's image ingest and ColPali retrieve: the scope
    reaches the index (a page outside the folder never comes back)."""
    import numpy as np

    from morphik_core_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(5)
    pages = []
    for _ in range(2):
        page = np.full((224, 224, 3), 255, np.uint8)
        for _ in range(5):
            y, x = rng.integers(0, 180, 2)
            page[y : y + 40, x : x + 40] = rng.integers(0, 200, 3)
        pages.append(encode_png(page))
    with Morphik(base_url=server_url) as db:
        inside = db.create_folder("colpali-scope").ingest_file(pages[0], filename="in.png", wait=True, timeout_s=240)
        outside = db.ingest_file(pages[1], filename="out.png", wait=True, timeout_s=240)
        assert inside.folder_path == "/colpali-scope" and outside.folder_path is None
        hits = db.folder("colpali-scope").retrieve_chunks("page", k=4, use_colpali=True)
        assert [h.document_id for h in hits] == [inside.external_id]
