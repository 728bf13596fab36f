"""Resumable export of multivector index namespaces to a portable dump:
PyTorch port of `scripts/export_chunks_resumable.py`, writing the same
bytes (batched, checkpointed, restartable).

Each namespace under the configured index_path exports as shards:
    <out>/<namespace>/shard_00000.jsonl   one line per chunk:
        {document_id, chunk_number, metadata, content_key, n_tokens}
    <out>/<namespace>/shard_00000.npy     float16 (sum_tokens, dim)
        multivector tokens, rows located by cumulative n_tokens
    <out>/<namespace>/manifest.json       written when complete

A checkpoint file records the next un-exported row per namespace; rerun
the same command after an interruption and completed shards are
skipped. Reads ride the index's own mmap path, so host RSS stays
bounded at any corpus size. Each namespace opens read-only
(`open_read_only`), so a live server's fresh rows are never cut.

    python -m morphik_core_tpu_torch.scripts.export_chunks_resumable --config morphik_tpu.toml
        --out ./export [--namespace NAME] [--batch 1000] [--checkpoint PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def fde_config_from(settings):
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    return FDEConfig(
        dimension=settings.model.embedding_dim,
        num_repetitions=settings.vector_store.fde_num_repetitions,
        num_simhash_projections=settings.vector_store.fde_num_simhash_projections,
        projection_dimension=settings.vector_store.fde_projection_dimension,
        seed=settings.vector_store.fde_seed,
    )


def export_namespace(ns_dir: Path, out_dir: Path, fde_cfg, batch: int, ckpt_path: Path, device=None) -> dict:
    """Export one namespace from its checkpointed row on."""
    from morphik_core_tpu_torch.index.multivector_index import open_read_only

    idx = open_read_only(fde_cfg, ns_dir, device=device)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = json.loads(ckpt_path.read_text()) if ckpt_path.exists() else {}
    start_row = int(ckpt.get(ns_dir.name, 0))
    n_rows = idx.count_rows
    shard = start_row // batch
    for lo in range(shard * batch, n_rows, batch):
        hi = min(lo + batch, n_rows)
        jsonl = out_dir / f"shard_{lo // batch:05d}.jsonl"
        npy = out_dir / f"shard_{lo // batch:05d}.npy"
        lines, token_parts = [], []
        for r in range(lo, hi):
            if not idx._alive[r]:
                continue
            rec = idx.records[r]
            mv = np.asarray(idx._mv_row(r), dtype=np.float16)
            lines.append(json.dumps({
                "document_id": rec.document_id,
                "chunk_number": rec.chunk_number,
                "metadata": rec.metadata,
                "content_key": rec.content_key,
                "n_tokens": int(mv.shape[0]),
            }, default=str))
            token_parts.append(mv)
        tokens = np.concatenate(token_parts) if token_parts else np.zeros((0, idx._dim), np.float16)
        # shard data lands fully before the checkpoint advances: a crash in
        # between re-exports the shard (an idempotent overwrite)
        np.save(npy, tokens)
        jsonl.write_text("".join(line + "\n" for line in lines))
        ckpt[ns_dir.name] = hi
        ckpt_path.write_text(json.dumps(ckpt))
    manifest = {
        "namespace": ns_dir.name,
        "rows_alive": len(idx),
        "rows_total": n_rows,
        "dim": idx._dim,
        "shards": -(-n_rows // batch) if n_rows else 0,
        "store_dtype": "float16",
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="morphik_tpu.toml")
    ap.add_argument("--out", required=True)
    ap.add_argument("--namespace", default=None, help="one namespace (default: all)")
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="torch device of the index (default: the card)")
    args = ap.parse_args(argv)

    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.scripts.check_completeness import namespace_dirs

    settings = load_settings(args.config)
    index_root = Path(settings.vector_store.index_path)
    out_root = Path(args.out)
    ckpt_path = Path(args.checkpoint) if args.checkpoint else out_root / "checkpoint.json"
    out_root.mkdir(parents=True, exist_ok=True)
    fde_cfg = fde_config_from(settings)

    ns_dirs = [index_root / args.namespace] if args.namespace else namespace_dirs(index_root)
    if not ns_dirs:
        print(json.dumps({"exported": 0, "namespaces": []}))
        return 0
    manifests = [export_namespace(ns_dir, out_root / ns_dir.name, fde_cfg, args.batch, ckpt_path, args.device)
                 for ns_dir in ns_dirs]
    print(json.dumps({"exported": sum(m["rows_alive"] for m in manifests), "namespaces": manifests}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
