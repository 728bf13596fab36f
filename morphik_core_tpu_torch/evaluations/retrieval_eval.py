"""Retrieval-quality harness, the port's copy of
`evaluations/retrieval_eval.py` (stdlib only; reference evaluations/hotpot_ragas_eval.py
computes RAGAS faithfulness/context-precision/answer-correctness over
HotpotQA). Offline equivalents computed here without an external judge:

  recall@k        — gold document retrieved within top-k
  mrr             — mean reciprocal rank of the first gold hit
  context_precision — fraction of retrieved chunks from gold documents
  answer_overlap  — token-F1 between the system answer and the gold
                    answer (the offline stand-in for answer-correctness)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence


@dataclass
class RetrievalCase:
    question: str
    gold_doc_ids: List[str]
    gold_answer: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)


def _tokens(s: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", s.lower())


def token_f1(pred: str, gold: str) -> float:
    p, g = _tokens(pred), _tokens(gold)
    if not p or not g:
        return 0.0
    common = 0
    gleft = list(g)
    for t in p:
        if t in gleft:
            gleft.remove(t)
            common += 1
    if common == 0:
        return 0.0
    precision, recall = common / len(p), common / len(g)
    return 2 * precision * recall / (precision + recall)


async def evaluate_retrieval(
    cases: Sequence[RetrievalCase],
    retrieve_fn,  # async (question) -> List[chunk] with .document_id
    answer_fn=None,  # optional async (question) -> str
    k: int = 4,
) -> Dict[str, Any]:
    recalls, mrrs, precisions, overlaps = [], [], [], []
    per_case = []
    for case in cases:
        chunks = await retrieve_fn(case.question)
        doc_ids = [getattr(c, "document_id", None) or c.get("document_id") for c in chunks][:k]
        gold = set(case.gold_doc_ids)
        hit_rank = next((i + 1 for i, d in enumerate(doc_ids) if d in gold), None)
        recalls.append(1.0 if hit_rank else 0.0)
        mrrs.append(1.0 / hit_rank if hit_rank else 0.0)
        precisions.append(
            sum(1 for d in doc_ids if d in gold) / max(len(doc_ids), 1)
        )
        row: Dict[str, Any] = {
            "question": case.question,
            "retrieved": doc_ids,
            "hit_rank": hit_rank,
        }
        if answer_fn is not None and case.gold_answer:
            ans = await answer_fn(case.question)
            f1 = token_f1(str(ans), case.gold_answer)
            overlaps.append(f1)
            row.update(answer=str(ans), answer_f1=f1)
        per_case.append(row)
    n = max(len(cases), 1)
    out = {
        "n_cases": len(cases),
        "recall_at_k": sum(recalls) / n,
        "mrr": sum(mrrs) / n,
        "context_precision": sum(precisions) / n,
        "cases": per_case,
    }
    if overlaps:
        out["answer_f1"] = sum(overlaps) / len(overlaps)
    return out
