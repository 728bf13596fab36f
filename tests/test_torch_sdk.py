"""The repo's Python SDK (`sdks/python`) against the port's server on the
CPU: the folder, document, summary, app, migrate, logs, v2 and connector
tests of `tests/test_sdk.py` run here unchanged on a port server
(imported, so they stay one body); the connector calls are also taken
further: a connector ingest waited to `completed` and retrieved, its
files paged, and the disconnect, sync and async."""

import asyncio
import threading

import pytest
import torch

from conftest import run_once
from test_sdk import (  # noqa: F401  (collected here, against this module's server_url)
    test_sdk_new_surface,   # before test_async_sdk_parity, as in test_sdk.py: it starts unauthenticated
    test_async_sdk_parity,
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


def test_sdk_new_surface_served_by_the_port(server_url, tmp_path):
    """`test_sdk.py::test_sdk_new_surface`'s connector calls taken to
    the end: the queued ingest completes and is retrieved, carrying its
    connector in its metadata; the auth status names the root; the
    disconnect answers as the reference's."""
    src = tmp_path / "conn_more"
    src.mkdir()
    (src / "m.txt").write_text("Connector memo: the relay trips at 11 amperes.")
    with Morphik(base_url=server_url) as db:
        db.connector_finalize_auth("local", {"root": str(src)})
        status = db.connector_auth_status("local")
        assert status["is_authenticated"] and status["message"] == f"root={src.resolve()}"
        queued = db.connector_ingest("local", "m.txt", use_colpali=False)
        assert queued["status"] == "queued"
        doc = db.wait_for_document_completion(queued["document"]["external_id"], timeout_s=120)
        assert doc.metadata["connector"] == {"type": "local", "file_id": "m.txt"}
        hits = db.retrieve_chunks("relay trips amperes", k=1, use_colpali=False)
        assert hits and "11 amperes" in hits[0].content
        assert db._post("/ee/connectors/local/disconnect", {})["status"] == "disconnected"
        assert db._post("/ee/connectors/local/disconnect", {})["status"] == "not_connected"


def test_async_sdk_parity_served_by_the_port(server_url, tmp_path):
    """`test_sdk.py::test_async_sdk_parity`'s connector calls taken
    further, async: a page of files past the first, an ingest, the
    disconnect."""
    src = tmp_path / "async_more"
    src.mkdir()
    for i in range(103):
        (src / f"f{i:03}.txt").write_text(f"async connector file {i}")

    async def go():
        async with AsyncMorphik(base_url=server_url) as db:
            await db.connector_finalize_auth("local", {"root": str(src)})
            first = await db.connector_list_files("local")
            assert len(first["files"]) == 100 and first["next_page_token"] == "100"
            rest = await db._get("/ee/connectors/local/files", page_token=first["next_page_token"])
            assert [f["name"] for f in rest["files"]] == ["f100.txt", "f101.txt", "f102.txt"]
            queued = await db.connector_ingest("local", "f007.txt", use_colpali=False)
            assert queued["status"] == "queued"
            assert (await db._post("/ee/connectors/local/disconnect", {}))["status"] == "disconnected"

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
