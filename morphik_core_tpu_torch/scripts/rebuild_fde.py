"""Re-encode an index's FDE vectors under a new MUVERA configuration:
PyTorch port of `scripts/rebuild_fde.py`, the document FDE computed on
the index's device (the card unless `--device cpu`).

The FDE config (repetitions / SimHash projections / sketch dims) is
baked into every stored prefilter vector, and the index refuses to load
one built under another config. This rebuilds the prefilter from the
stored exact multivectors; rerank fidelity is untouched because the
multivectors are copied as they are. Per namespace, the rebuild goes
into <ns>.rebuild and is then swapped in. The script first takes each
namespace's exclusive lock, and exits 2 without writing while a port
server holds one.

    python -m morphik_core_tpu_torch.scripts.rebuild_fde --index-path ./storage/index
        --num-repetitions 20 --num-simhash-projections 5 --projection-dimension 16
        [--namespace NS]... [--dimension 128] [--batch 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np


def rebuild_namespace(ns_dir: Path, new_cfg, batch: int, device=None) -> str:
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    t0 = time.time()
    # load with the ON-DISK config (header.json): the index refuses a
    # mismatched config by design
    with open(ns_dir / "header.json") as fh:
        h = json.load(fh)["fde"]
    old_cfg = FDEConfig(
        dimension=h["dimension"],
        num_repetitions=h["num_repetitions"],
        num_simhash_projections=h["num_simhash_projections"],
        projection_dimension=h["projection_dimension"],
        projection_type=h.get("projection_type", "AMS_SKETCH"),
        seed=h.get("seed", 42),
    )
    old = MultiVectorIndex(old_cfg, path=ns_dir, device=device)
    alive_rows = [r for r in range(old.count_rows) if old._alive[r]]
    tmp = ns_dir.with_name(ns_dir.name + ".rebuild")
    if tmp.exists():
        shutil.rmtree(tmp)
    new = MultiVectorIndex(new_cfg, path=tmp, store_dtype=old.store_dtype, device=device)
    for i in range(0, len(alive_rows), batch):
        rows = alive_rows[i : i + batch]
        mvs = [old._mv_row(r).astype(np.float32) for r in rows]
        recs = [IndexRecord(document_id=old.records[r].document_id, chunk_number=old.records[r].chunk_number,
                            metadata=old.records[r].metadata, content_key=old.records[r].content_key)
                for r in rows]
        new.store(mvs, recs)  # re-encodes the FDE under new_cfg
        new.save()
        print(f"  {min(i + batch, len(alive_rows))}/{len(alive_rows)}", end="\r")
    for name in ("header.json", "records.jsonl", "fde.bin", "mv.bin"):
        src = tmp / name
        if src.exists():
            os.replace(src, ns_dir / name)
        elif (ns_dir / name).exists():
            (ns_dir / name).unlink()
    shutil.rmtree(tmp, ignore_errors=True)
    check = MultiVectorIndex(new_cfg, path=ns_dir, device=device)
    if len(check) != len(alive_rows):
        raise RuntimeError(f"row mismatch after rebuild: {len(check)} != {len(alive_rows)}")
    return f"re-encoded {len(alive_rows)} rows in {time.time() - t0:.1f}s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--index-path", required=True)
    ap.add_argument("--namespace", action="append")
    ap.add_argument("--dimension", type=int, default=128)
    ap.add_argument("--num-repetitions", type=int, default=20)
    ap.add_argument("--num-simhash-projections", type=int, default=5)
    ap.add_argument("--projection-dimension", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device of the FDE encode (default: the card)")
    args = ap.parse_args(argv)

    from morphik_core_tpu_torch.ops.fde import FDEConfig

    cfg = FDEConfig(
        dimension=args.dimension,
        num_repetitions=args.num_repetitions,
        num_simhash_projections=args.num_simhash_projections,
        projection_dimension=args.projection_dimension,
    )
    from morphik_core_tpu_torch.index.multivector_index import NamespaceBusy, exclusive_namespaces

    root = Path(args.index_path)
    ns_dirs = [root / n for n in args.namespace] if args.namespace else sorted(p for p in root.iterdir() if p.is_dir())
    try:
        with exclusive_namespaces(ns_dirs):
            for ns_dir in ns_dirs:
                if not ((ns_dir / "records.jsonl").exists() or (ns_dir / "meta.json").exists()):
                    print(f"{ns_dir.name}: not an index dir (skipped)")
                    continue
                print(f"{ns_dir.name}: {rebuild_namespace(ns_dir, cfg, args.batch, args.device)}")
    except NamespaceBusy as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
