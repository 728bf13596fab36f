"""Migrate legacy multivector-index snapshots (round-1 layout: meta.json
+ fde.npy + multivectors/{row}.npy) to the append-only format
(header.json + records.jsonl WAL + fde.bin + mv.bin), offline: PyTorch
port of `scripts/migrate_index_format.py`.

The index migrates lazily on load (`MultiVectorIndex._load_legacy`), but
that puts the one-time O(corpus) cost on the first boot after an
upgrade; this script does it ahead of time and verifies the result.

    python -m morphik_core_tpu_torch.scripts.migrate_index_format --index-path ./storage/index
        [--namespace NS]... [--query-smoke] [--config morphik_tpu.toml | --dimension D
        --num-repetitions R --num-simhash-projections P --projection-dimension S] [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

import numpy as np


def migrate_namespace(ns_dir: Path, fde_cfg, query_smoke: bool, device=None) -> str:
    from morphik_core_tpu_torch.index.multivector_index import MultiVectorIndex

    if (ns_dir / "records.jsonl").exists():
        return "already append-only"
    if not (ns_dir / "meta.json").exists():
        return "not an index dir (skipped)"
    t0 = time.time()
    idx = MultiVectorIndex(fde_cfg, path=ns_dir, device=device)  # _load_legacy ingests the snapshot
    alive = len(idx)
    idx.save()  # writes the append-only layout
    # drop superseded legacy files only after a successful save
    (ns_dir / "meta.json").unlink(missing_ok=True)
    (ns_dir / "fde.npy").unlink(missing_ok=True)
    legacy_dir = ns_dir / "multivectors"
    if legacy_dir.exists():
        shutil.rmtree(legacy_dir, ignore_errors=True)
    # verify: reload from the new layout
    re = MultiVectorIndex(fde_cfg, path=ns_dir, device=device)
    if len(re) != alive:
        raise RuntimeError(f"row mismatch after migration: {len(re)} != {alive}")
    if query_smoke and alive:
        q = np.ones((4, re.fde_config.dimension), np.float32)
        if not re.query(q, k=min(3, alive)):
            raise RuntimeError("query smoke returned nothing")
    return f"migrated {alive} rows in {time.time() - t0:.1f}s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--index-path", required=True)
    ap.add_argument("--namespace", action="append", help="migrate only these namespaces")
    ap.add_argument("--query-smoke", action="store_true", help="run a query after each migration")
    ap.add_argument("--config", help="morphik_tpu.toml to read the FDE config from")
    # legacy snapshots carry no header.json: the FDE config the index was
    # built with must be supplied (or read from the service config)
    ap.add_argument("--dimension", type=int)
    ap.add_argument("--num-repetitions", type=int)
    ap.add_argument("--num-simhash-projections", type=int)
    ap.add_argument("--projection-dimension", type=int)
    ap.add_argument("--device", default=None, help="torch device of the index (default: the card)")
    args = ap.parse_args(argv)

    from morphik_core_tpu_torch.ops.fde import FDEConfig

    if args.config:
        from morphik_core_tpu_torch.config import load_settings

        settings = load_settings(args.config)
        vs = settings.vector_store
        fde_cfg = FDEConfig(
            dimension=settings.model.embedding_dim,
            num_repetitions=vs.fde_num_repetitions,
            num_simhash_projections=vs.fde_num_simhash_projections,
            projection_dimension=vs.fde_projection_dimension,
        )
    else:
        defaults = FDEConfig()
        fde_cfg = FDEConfig(
            dimension=args.dimension or defaults.dimension,
            num_repetitions=args.num_repetitions or defaults.num_repetitions,
            num_simhash_projections=args.num_simhash_projections or defaults.num_simhash_projections,
            projection_dimension=args.projection_dimension or defaults.projection_dimension,
        )

    root = Path(args.index_path)
    if not root.exists():
        print(f"no index at {root}", file=sys.stderr)
        return 1
    ns_dirs = [root / n for n in args.namespace] if args.namespace else sorted(p for p in root.iterdir() if p.is_dir())
    for ns_dir in ns_dirs:
        print(f"{ns_dir.name}: {migrate_namespace(ns_dir, fde_cfg, args.query_smoke, args.device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
