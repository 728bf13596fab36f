"""Scrub user metadata from stored documents: PyTorch port of
`scripts/scrub_metadata.py` (keeps only the `--keep` keys), batched and
dry-run-able. Also scrubs the matching index-record metadata so
filterable state cannot leak through retrieval results.

    python -m morphik_core_tpu_torch.scripts.scrub_metadata --config morphik_tpu.toml
        [--keep external_id,title] [--apply] [--dry-run-index] [--batch 100] [--device cpu]

Without --apply the script only reports what it WOULD change, opening
the index read-only. With --apply it first takes every namespace's
exclusive lock, and exits 2 without writing while a port server holds
one.
"""

from __future__ import annotations

import argparse
import json
import sqlite3
import sys
from pathlib import Path


def scrub(args) -> dict:
    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.index.multivector_index import MultiVectorIndex, exclusive_namespaces, open_read_only
    from morphik_core_tpu_torch.scripts.check_completeness import namespace_dirs

    settings = load_settings(args.config)
    ns_dirs = namespace_dirs(Path(settings.vector_store.index_path))
    with exclusive_namespaces(ns_dirs if args.apply else ()):  # NamespaceBusy before any write
        keep = {k.strip() for k in args.keep.split(",") if k.strip()}
        conn = sqlite3.connect(settings.database.path)
        conn.row_factory = sqlite3.Row
        rows = conn.execute("SELECT external_id, doc_metadata FROM documents").fetchall()
        changed = 0
        batch = []
        for r in rows:
            meta = json.loads(r["doc_metadata"] or "{}")
            scrubbed = {k: v for k, v in meta.items() if k in keep}
            if scrubbed != meta:
                changed += 1
                batch.append((json.dumps(scrubbed), r["external_id"]))
            if args.apply and len(batch) >= args.batch:
                conn.executemany("UPDATE documents SET doc_metadata = ? WHERE external_id = ?", batch)
                conn.commit()
                batch = []
        if args.apply and batch:
            conn.executemany("UPDATE documents SET doc_metadata = ? WHERE external_id = ?", batch)
            conn.commit()
        conn.close()

        # index-record metadata (the retrieval path serves this copy)
        index_changed = 0
        if args.apply or args.dry_run_index:
            from morphik_core_tpu_torch.scripts.export_chunks_resumable import fde_config_from

            fde_cfg = fde_config_from(settings)
            device = getattr(args, "device", None)
            for ns_dir in ns_dirs:
                idx = (MultiVectorIndex(fde_cfg, path=ns_dir, device=device) if args.apply
                       else open_read_only(fde_cfg, ns_dir, device=device))
                dirty = False
                for r in range(idx.count_rows):
                    rec = idx.records[r]
                    scrubbed = {k: v for k, v in rec.metadata.items() if k in keep}
                    if scrubbed != rec.metadata:
                        index_changed += 1
                        if args.apply:
                            rec.metadata = scrubbed
                            dirty = True
                if dirty:
                    # compaction rewrites every WAL line with the live
                    # (scrubbed) record metadata
                    idx.compact()
                    idx.save()
    return {"documents_scrubbed": changed, "index_records_scrubbed": index_changed, "applied": bool(args.apply)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="morphik_tpu.toml")
    ap.add_argument("--keep", default="external_id")
    ap.add_argument("--apply", action="store_true")
    ap.add_argument("--dry-run-index", action="store_true", help="count index-record changes in dry-run mode too")
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--device", default=None, help="torch device of the index (default: the card)")
    args = ap.parse_args(argv)
    from morphik_core_tpu_torch.index.multivector_index import NamespaceBusy

    try:
        print(json.dumps(scrub(args)))
    except NamespaceBusy as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
