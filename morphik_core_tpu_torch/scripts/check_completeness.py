"""Consistency check across the three places a chunk lives: PyTorch port
of `scripts/check_completeness.py` (SQLite documents vs index rows vs
storage payloads).

Checks, per namespace (app_id or "default"):
  1. every COMPLETED document's multivector chunk_ids exist in the index
  2. every index row's document exists in the DB and is not failed
  3. every index row's content_key (offloaded payload) exists in storage

Also emits a GC plan (`gc_plan` in the report): storage objects nothing
references any more (per-chunk payloads with no alive index row, raw
`ingest/...` uploads whose document is gone from the DB). `--gc-apply`
deletes exactly the planned objects, with one guard the reference lacks
(`scripts/check_completeness.py:137` fails open): when the index root
holds no namespace while the plan lists payload objects, the plan
would delete every payload of a deployment whose index is missing or
misconfigured, so the apply is refused (`gc_refused` in the report,
exit code 2) and nothing is deleted.

The check opens each namespace read-only (`open_read_only`: a live
server's fresh rows are never cut). `--gc-apply` first takes each
namespace's exclusive lock: while a port server holds one, a chunk may
be in flight (its payload uploaded, its rows not yet saved), so the
apply is refused (exit code 2, `gc_refused`) and the locks are held
until the deletes are done. A namespace that appears meanwhile refuses
the apply too.

Prints one JSON report (the reference's); exit code 1 when any
inconsistency is found (orphaned-but-harmless GC candidates do not flip
it), 2 when `--gc-apply` is refused.

    python -m morphik_core_tpu_torch.scripts.check_completeness --config morphik_tpu.toml
        [--gc-apply] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
from pathlib import Path

GC_REFUSED_EMPTY_ROOT = ("no index namespace under the index root, while the plan lists payload objects: "
                         "refusing to delete them (check vector_store.index_path)")


def namespace_dirs(index_root: Path) -> list:
    """The namespace directories of an index root (a compaction's side
    directory is not one)."""
    if not index_root.exists():
        return []
    return sorted(d for d in index_root.iterdir() if d.is_dir() and not d.name.endswith(".compact"))


async def check(args) -> dict:
    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
    from morphik_core_tpu_torch.index.multivector_index import NamespaceBusy, exclusive_namespaces, open_read_only
    from morphik_core_tpu_torch.scripts.export_chunks_resumable import fde_config_from
    from morphik_core_tpu_torch.services_init import build_storage
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import _DEFAULT_NS, MULTIVECTOR_CHUNKS_BUCKET

    settings = load_settings(args.config)
    db = SQLiteDatabase(settings.database.path)
    await db.initialize()
    storage = build_storage(settings)
    index_root = Path(settings.vector_store.index_path)
    fde_cfg = fde_config_from(settings)
    device = getattr(args, "device", None)

    # --- DB side: completed documents and their chunk ids, per namespace
    rows = db._conn.execute("SELECT external_id, app_id, status, chunk_ids FROM documents").fetchall()
    db_docs = {}  # (ns, doc_id) -> (status, [chunk ids])
    for r in rows:
        ns = r["app_id"] or _DEFAULT_NS
        db_docs[(ns, r["external_id"])] = (r["status"], json.loads(r["chunk_ids"] or "[]"))

    report = {
        "namespaces": {},
        "missing_index_rows": [],  # completed doc chunk id absent from index
        "orphan_index_rows": [],  # index row whose document is gone/failed
        "missing_payloads": [],  # content_key absent from storage
    }
    alive_payload_keys = set()  # content_keys referenced by ANY alive index row
    ns_dirs = namespace_dirs(index_root)
    held, busy = contextlib.ExitStack(), None  # the locks, held until the deletes are done
    if getattr(args, "gc_apply", False):
        try:
            held.enter_context(exclusive_namespaces(ns_dirs))
        except NamespaceBusy as e:
            busy = str(e)
    for ns_dir in ns_dirs:
        ns = ns_dir.name
        idx = open_read_only(fde_cfg, ns_dir, device=device)
        alive = [r for r in range(idx.count_rows) if idx._alive[r]]
        index_ids = {f"{idx.records[r].document_id}-{idx.records[r].chunk_number}" for r in alive}
        index_docs = {idx.records[r].document_id for r in alive}
        report["namespaces"][ns] = {"index_rows": len(index_ids), "index_docs": len(index_docs)}

        # 1. completed docs -> index rows (only ids shaped like index ids:
        #    the text store owns the "<uuid4>" single-vector chunk ids)
        for (dns, doc_id), (status, chunk_ids) in db_docs.items():
            if dns != ns or status != "completed":
                continue
            for cid in chunk_ids:
                if cid.startswith(f"{doc_id}-") and cid not in index_ids:
                    report["missing_index_rows"].append({"namespace": ns, "chunk_id": cid})

        # 2. index docs -> DB status
        for doc_id in sorted(index_docs):
            status = db_docs.get((ns, doc_id), (None, None))[0]
            if status in (None, "failed"):
                report["orphan_index_rows"].append({"namespace": ns, "document_id": doc_id, "db_status": status})

        # 3. payload keys -> storage objects
        for r in alive:
            key = idx.records[r].content_key
            if not key:
                continue
            alive_payload_keys.add(key)
            if await storage.get_object_size(MULTIVECTOR_CHUNKS_BUCKET, key) is None:
                report["missing_payloads"].append({"namespace": ns, "content_key": key})
    db.close()

    # --- GC plan: per-chunk payloads with no alive index row, and raw
    # uploads (ingest/<doc_id>/...) whose document is in the DB at no status
    gc = {"orphan_payload_objects": [], "orphan_raw_objects": [], "reclaim_bytes": 0}
    for key, size in await storage.list_objects(MULTIVECTOR_CHUNKS_BUCKET):
        if key not in alive_payload_keys:
            gc["orphan_payload_objects"].append({"key": key, "bytes": size})
            gc["reclaim_bytes"] += size
    known_doc_ids = {doc_id for (_ns, doc_id) in db_docs}
    for key, size in await storage.list_objects("", prefix="ingest/"):
        parts = key.split("/")
        if len(parts) >= 2 and parts[1] not in known_doc_ids:
            gc["orphan_raw_objects"].append({"key": key, "bytes": size})
            gc["reclaim_bytes"] += size
    report["gc_plan"] = gc

    if getattr(args, "gc_apply", False):
        if busy is not None:
            report["gc_refused"] = f"{busy}: a chunk may be in flight, refusing to delete payloads"
        elif not ns_dirs and gc["orphan_payload_objects"]:
            report["gc_refused"] = GC_REFUSED_EMPTY_ROOT
        elif namespace_dirs(index_root) != ns_dirs:
            report["gc_refused"] = "a namespace appeared while the plan was made: run the check again"
        else:
            deleted = 0
            for obj in gc["orphan_payload_objects"]:
                if await storage.delete_file(MULTIVECTOR_CHUNKS_BUCKET, obj["key"]):
                    deleted += 1
            for obj in gc["orphan_raw_objects"]:
                if await storage.delete_file("", obj["key"]):
                    deleted += 1
            report["gc_applied"] = deleted
    held.close()
    report["consistent"] = not (
        report["missing_index_rows"] or report["orphan_index_rows"] or report["missing_payloads"]
    )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="morphik_tpu.toml")
    ap.add_argument("--gc-apply", action="store_true", help="delete the objects the GC plan lists as orphaned")
    ap.add_argument("--device", default=None, help="torch device of the index (default: the card)")
    args = ap.parse_args(argv)
    report = asyncio.run(check(args))
    print(json.dumps(report, indent=1))
    if "gc_refused" in report:
        return 2
    return 0 if report["consistent"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
