#!/usr/bin/env python3
"""HotpotQA adapter, the port's copy of `evaluations/hotpot_adapter.py`
(reference evaluations/hotpot_ragas_eval.py runs
RAGAS over HotpotQA). Converts a HotpotQA-format JSON file (the public
distractor/fullwiki dev sets) into a corpus directory + questions file
for run_offline_eval.py — the offline retrieval metrics (recall@k, MRR,
context precision, answer token-F1) stand in for the RAGAS judge, which
needs an external LLM.

Usage:
    python -m morphik_core_tpu_torch.evaluations.hotpot_adapter hotpot_dev.json out_dir [--limit 50]
    python -m morphik_core_tpu_torch.evaluations.run_offline_eval --corpus out_dir/corpus \
        --questions out_dir/questions.json
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path


def convert(hotpot_path: Path, out_dir: Path, limit: int = 50) -> dict:
    rows = json.loads(hotpot_path.read_text())[:limit]
    corpus = out_dir / "corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    questions = []
    seen_titles = set()
    for row in rows:
        gold_titles = {t for t, _ in row.get("supporting_facts", [])}
        gold_files = []
        for title, sentences in row.get("context", []):
            fname = re.sub(r"[^A-Za-z0-9]+", "_", title)[:80] + ".txt"
            if title not in seen_titles:
                (corpus / fname).write_text(f"{title}\n\n" + " ".join(sentences))
                seen_titles.add(title)
            if title in gold_titles:
                gold_files.append(fname)
        questions.append(
            {
                "question": row["question"],
                "expected_answer": row.get("answer", ""),
                "gold_docs": gold_files,
            }
        )
    (out_dir / "questions.json").write_text(json.dumps(questions, indent=1))
    return {"questions": len(questions), "documents": len(seen_titles)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("hotpot_json", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--limit", type=int, default=50)
    args = ap.parse_args()
    out = convert(args.hotpot_json, args.out_dir, args.limit)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
