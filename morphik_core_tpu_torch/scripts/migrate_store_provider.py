"""Resumable multivector-store migration: move every chunk of every
document from one store provider to another. PyTorch port of
`scripts/migrate_store_provider.py`; the stores live under
`{index_path}/provider_{name}` on the card unless `--device cpu`.

    python -m morphik_core_tpu_torch.scripts.migrate_store_provider
        --config morphik_tpu.toml --from fde --to fde
        [--checkpoint ./storage/migration.ckpt.json] [--batch 64] [--device cpu]

Checkpointing: after each document the set of migrated doc IDs is
written to the checkpoint file (JSON); a rerun skips them, so the
migration survives an interruption.

`--to binary` is refused. The binary index keeps no files (its `save()`
is a no-op in both packages), so a migration would write a checkpoint
that marks every document migrated while nothing it wrote outlives the
process. The reference does not get that far: its binary store raises a
TypeError on every document and its final `save()` an AttributeError
(ROADMAP, divergences). `--from` takes only "fde": the binary provider
keeps only sign bits, so leaving it means re-ingesting.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

REFUSE_TO_BINARY = ("refusing --to binary: the binary index keeps no files (its save() is a no-op), so the "
                    "checkpoint would mark every document migrated while nothing it wrote survives the process; "
                    "a binary store is built from its documents' multivectors when it is served")


async def migrate(args: argparse.Namespace) -> int:
    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
    from morphik_core_tpu_torch.models.schemas import AuthContext, EntityType
    from morphik_core_tpu_torch.scripts.export_chunks_resumable import fde_config_from
    from morphik_core_tpu_torch.services_init import build_storage
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

    settings = load_settings(args.config)
    storage = build_storage(settings)
    db = SQLiteDatabase(settings.database.path)
    await db.initialize()
    fde_cfg = fde_config_from(settings)

    def make_store(provider: str) -> TorchMultiVectorStore:
        return TorchMultiVectorStore(
            storage=storage,
            fde_config=fde_cfg,
            index_path=Path(settings.vector_store.index_path) / f"provider_{provider}",
            provider=provider,
            device=args.device,
        )

    src, dst = make_store(args.src), make_store(args.dst)
    await src.initialize()
    await dst.initialize()

    ckpt_path = Path(args.checkpoint)
    done: set = set()
    if ckpt_path.exists():
        done = set(json.loads(ckpt_path.read_text())["migrated"])
        print(f"resuming: {len(done)} documents already migrated")

    auth = AuthContext(entity_type=EntityType.DEVELOPER, entity_id="migration",
                       permissions={"read", "write", "admin"})
    docs = await db.get_documents(auth, 0, 1_000_000)
    migrated = errors = 0
    for doc in docs:
        if doc.external_id in done:
            continue
        try:
            ids = [(doc.external_id, n) for n in range(len(doc.chunk_ids) or 0)]
            if not ids:
                done.add(doc.external_id)
                continue
            chunks = await src.get_chunks_by_id(ids, app_id=doc.app_id)
            # the raw multivectors come from the source index
            index = src._ns(doc.app_id)
            full = []
            for c in chunks:
                mv = index.get_multivector(c.document_id, c.chunk_number)
                if mv is None:
                    continue
                c.embedding = mv
                full.append(c)
            if full:
                ok, _, _ = await dst.store_embeddings(full, app_id=doc.app_id)
                if not ok:
                    raise RuntimeError("store failed")
            migrated += 1
            done.add(doc.external_id)
            ckpt_path.parent.mkdir(parents=True, exist_ok=True)
            ckpt_path.write_text(json.dumps({"migrated": sorted(done)}))
            if migrated % 50 == 0:
                print(f"migrated {migrated} documents...")
        except Exception as e:  # noqa: BLE001 — count it, go on with the next document
            errors += 1
            print(f"ERROR migrating {doc.external_id}: {e}")
    db.close()
    dst.save()
    print(f"done: migrated={migrated} skipped={len(done) - migrated} errors={errors}")
    return 0 if errors == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="morphik_tpu.toml")
    ap.add_argument("--from", dest="src", required=True, choices=["fde"])
    ap.add_argument("--to", dest="dst", required=True, choices=["binary", "fde"])
    ap.add_argument("--checkpoint", default="./storage/migration.ckpt.json")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device of the stores (default: the card)")
    args = ap.parse_args(argv)
    if args.dst == "binary":
        print(REFUSE_TO_BINARY, file=sys.stderr)
        return 2
    return asyncio.run(migrate(args))


if __name__ == "__main__":
    raise SystemExit(main())
