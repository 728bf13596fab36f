"""Destroy one app's namespace everywhere it has state: PyTorch port of
`scripts/purge_app.py` (the walk is app -> DB rows -> index namespace ->
text-index namespace -> storage payloads).

What gets removed for `--app-id APP`:
  - documents / folders / chats / model_configs / storage_usage rows
    (main sqlite DB, WHERE app_id = APP)
  - the multivector index namespace dir  {index_path}/APP  (+ any
    leftover .compact side-dir)
  - the text-index namespace files       {storage_path}/text_index/APP.*
  - per-chunk payload objects            multivector-chunks/APP/...
    (LISTED from storage, so orphans no longer referenced by the index
    are also reclaimed)
  - raw uploads referenced by each doc's storage_info
  - the app registry row (user_limits.db), decrementing the owner's
    apps_used / storage_bytes counters

`--app-id default` purges rows whose app_id IS NULL (the self-hosted
default namespace). Nothing here touches the card; the script runs where
the port does.

    python -m morphik_core_tpu_torch.scripts.purge_app --config morphik_tpu.toml --app-id APP --dry-run
    python -m morphik_core_tpu_torch.scripts.purge_app --config morphik_tpu.toml --app-id APP --yes
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import sqlite3
import sys
from pathlib import Path

_APP_TABLES = ("documents", "folders", "chats", "model_configs", "storage_usage")


def _app_where(app_id: str):
    """WHERE clause + params for one app namespace ('default' = NULL app_id)."""
    if app_id == "default":
        return "app_id IS NULL", ()
    return "app_id = ?", (app_id,)


def _settings_and_storage(args):
    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.services_init import build_storage

    settings = load_settings(args.config)
    return settings, build_storage(settings)


async def plan(args) -> dict:
    """Walk every store and inventory what a purge would remove."""
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import MULTIVECTOR_CHUNKS_BUCKET

    settings, storage = _settings_and_storage(args)
    ns = args.app_id
    where, params = _app_where(ns)

    inv = {
        "app_id": ns,
        "db_rows": {},
        "raw_objects": [],  # [bucket, key] from each doc's storage_info
        "payload_objects": [],  # [key, bytes] listed under multivector-chunks/<ns>/
        "payload_bytes": 0,
        "accounted_bytes": 0,
        "index_dirs": [],
        "text_index_files": [],
        "registry": None,
    }

    db_path = Path(settings.database.path)
    if db_path.exists():
        conn = sqlite3.connect(db_path)
        conn.row_factory = sqlite3.Row
        for table in _APP_TABLES:
            n = conn.execute(f"SELECT COUNT(*) FROM {table} WHERE {where}", params).fetchone()[0]
            inv["db_rows"][table] = int(n)
        for r in conn.execute(f"SELECT external_id, storage_info FROM documents WHERE {where}", params):
            si = json.loads(r["storage_info"] or "{}")
            if si.get("key"):
                inv["raw_objects"].append([si.get("bucket", ""), si["key"]])
        # what the quota system charged this app (the owner's
        # user_limits.storage_bytes refund on purge)
        inv["accounted_bytes"] = int(
            conn.execute(f"SELECT COALESCE(SUM(bytes),0) FROM storage_usage WHERE {where}", params).fetchone()[0]
        )
        conn.close()

    index_root = Path(settings.vector_store.index_path)
    for d in (index_root / ns, index_root / f"{ns}.compact"):
        if d.exists():
            inv["index_dirs"].append(str(d))
    text_root = Path(settings.storage.storage_path) / "text_index"
    if text_root.exists():
        inv["text_index_files"] = sorted(str(p) for p in text_root.glob(f"{ns}.*"))

    for key, size in await storage.list_objects(MULTIVECTOR_CHUNKS_BUCKET, prefix=f"{ns}/"):
        inv["payload_objects"].append([key, size])
        inv["payload_bytes"] += size

    # app registry (separate user_limits.db)
    user_db = Path(settings.storage.storage_path) / "user_limits.db"
    if user_db.exists() and ns != "default":
        conn = sqlite3.connect(user_db)
        conn.row_factory = sqlite3.Row
        row = conn.execute("SELECT app_id, user_id, name FROM apps WHERE app_id=?", (ns,)).fetchone()
        if row:
            inv["registry"] = dict(row)
        conn.close()

    inv["empty"] = not (
        any(inv["db_rows"].values())
        or inv["raw_objects"]
        or inv["payload_objects"]
        or inv["index_dirs"]
        or inv["text_index_files"]
        or inv["registry"]
    )
    return inv


async def purge(args, inv: dict) -> dict:
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import MULTIVECTOR_CHUNKS_BUCKET

    settings, storage = _settings_and_storage(args)
    ns = args.app_id
    where, params = _app_where(ns)
    done = {"payload_objects": 0, "raw_objects": 0, "db_rows": 0, "index_dirs": 0,
            "text_index_files": 0, "registry": False}

    for key, _size in inv["payload_objects"]:
        if await storage.delete_file(MULTIVECTOR_CHUNKS_BUCKET, key):
            done["payload_objects"] += 1
    for bucket, key in inv["raw_objects"]:
        try:
            if await storage.delete_file(bucket, key):
                done["raw_objects"] += 1
        except Exception as e:  # noqa: BLE001 — keep purging; report at end
            print(f"raw delete failed for {bucket}/{key}: {e}", file=sys.stderr)

    for d in inv["index_dirs"]:
        shutil.rmtree(d, ignore_errors=True)
        done["index_dirs"] += 1
    for f in inv["text_index_files"]:
        Path(f).unlink(missing_ok=True)
        done["text_index_files"] += 1

    db_path = Path(settings.database.path)
    if db_path.exists():
        conn = sqlite3.connect(db_path)
        for table in _APP_TABLES:
            cur = conn.execute(f"DELETE FROM {table} WHERE {where}", params)
            done["db_rows"] += cur.rowcount
        conn.commit()
        conn.close()

    if inv["registry"]:
        user_db = Path(settings.storage.storage_path) / "user_limits.db"
        conn = sqlite3.connect(user_db)
        cur = conn.execute("DELETE FROM apps WHERE app_id=? AND user_id=?", (ns, inv["registry"]["user_id"]))
        if cur.rowcount:
            conn.execute(
                "UPDATE user_limits SET apps_used = MAX(apps_used - 1, 0),"
                " storage_bytes = MAX(storage_bytes - ?, 0) WHERE user_id=?",
                (inv.get("accounted_bytes", 0), inv["registry"]["user_id"]),
            )
            done["registry"] = True
        conn.commit()
        conn.close()
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="morphik_tpu.toml")
    ap.add_argument("--app-id", required=True)
    ap.add_argument("--dry-run", action="store_true", help="inventory only, delete nothing")
    ap.add_argument("--yes", action="store_true", help="skip the confirmation prompt")
    ap.add_argument("--device", default=None, help="accepted as the other scripts take it; the purge uses no device")
    args = ap.parse_args(argv)

    inv = asyncio.run(plan(args))
    print(json.dumps({"plan": inv}, indent=1))
    if args.dry_run or inv["empty"]:
        return 0
    if not args.yes:
        reply = input(f"Purge app {args.app_id!r} everywhere? Type the app id to confirm: ")
        if reply.strip() != args.app_id:
            print("aborted")
            return 2
    done = asyncio.run(purge(args, inv))
    print(json.dumps({"purged": done}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
