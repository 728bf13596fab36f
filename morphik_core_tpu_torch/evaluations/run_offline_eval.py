#!/usr/bin/env python3
"""Offline end-to-end RAG evaluation on the port: twin of
`evaluations/run_offline_eval.py` (reference evaluations/custom_eval runs
a 45-question financial benchmark against a deployment; this runner is
the same harness self-contained: spin the port's services in-process,
ingest a corpus, answer questions, print accuracy + retrieval metrics as
JSON, the original's keys).

Usage:
    python -m morphik_core_tpu_torch.evaluations.run_offline_eval [--corpus DIR]
        [--questions FILE.json] [--use-colpali] [--out FILE.json] [--cpu]

Without arguments a small built-in corpus/question set runs (useful as a
smoke benchmark of the whole pipeline). The repo's benchmark is
`--corpus evaluations/benchmark/corpus --questions
evaluations/benchmark/questions.json` (a data directory: read, never
imported). The services run on the card, or on the CPU with `--cpu`;
beyond the original, the telemetry directory lies in the run's temporary
directory too."""

from __future__ import annotations

import argparse
import asyncio
import json
import tempfile
from pathlib import Path

BUILTIN_CORPUS = {
    "reactor.txt": "The primary reactor outputs 340 megawatts. Coolant is liquid sodium.",
    "finance.txt": "Q3 revenue was 12.5 million dollars, up 8 percent year over year.",
    "wildlife.txt": "Arctic terns migrate roughly 70,000 kilometres every year.",
}
BUILTIN_QUESTIONS = [
    {"question": "What is the reactor's power output?", "expected_answer": "340 megawatts",
     "gold_docs": ["reactor.txt"]},
    {"question": "What was Q3 revenue?", "expected_answer": "12.5 million",
     "gold_docs": ["finance.txt"]},
    {"question": "How far do arctic terns migrate?", "expected_answer": "70,000",
     "gold_docs": ["wildlife.txt"]},
]


def build_judge(args):
    """LLM judge behind any configured OpenAI-compatible endpoint, with
    deterministic substring fallback (reference uses an LLM judge for
    its benchmark, custom_eval/README.md). Configure via flags or env
    MORPHIK_JUDGE_API_BASE / MORPHIK_JUDGE_MODEL / MORPHIK_JUDGE_API_KEY."""
    import os

    from morphik_core_tpu_torch.evaluations.judge import LLMJudge

    api_base = args.judge_api_base or os.environ.get("MORPHIK_JUDGE_API_BASE")
    if not api_base:
        return None, "substring (deterministic; set --judge-api-base for the LLM judge)"
    model = args.judge_model or os.environ.get("MORPHIK_JUDGE_MODEL", "gpt-4o-mini")
    key = args.judge_api_key or os.environ.get("MORPHIK_JUDGE_API_KEY")
    return LLMJudge(api_base, model=model, api_key=key), f"llm:{model}@{api_base}"


async def run_eval(corpus_dir: Path, questions: list, use_colpali: bool, judge=None, device=None) -> dict:
    """`device`: the services' (the card unless the caller passes "cpu")."""
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.evaluations.base_eval import EvalQuestion, MorphikTPUEvaluator
    from morphik_core_tpu_torch.evaluations.retrieval_eval import RetrievalCase, evaluate_retrieval
    from morphik_core_tpu_torch.models.schemas import AuthContext, EntityType
    from morphik_core_tpu_torch.services_init import build_services

    with tempfile.TemporaryDirectory() as tmp:
        settings = Settings.from_dict(
            {
                "storage": {"storage_path": f"{tmp}/storage"},
                "database": {"path": f"{tmp}/db.sqlite"},
                "vector_store": {"index_path": f"{tmp}/index"},
                "telemetry": {"telemetry_dir": f"{tmp}/telemetry"},
            }
        )
        services = build_services(settings, device=device)
        await services.database.initialize()
        auth = AuthContext(
            entity_type=EntityType.DEVELOPER, entity_id="eval",
            permissions={"read", "write", "admin"}, user_id="eval",
        )
        evaluator = MorphikTPUEvaluator(services, auth, use_colpali=use_colpali, judge=judge)
        await evaluator.ingest(corpus_dir)

        # filename -> doc id map for retrieval metrics
        docs = await services.database.get_documents(auth, 0, 10_000)
        by_name = {d.filename: d.external_id for d in docs}

        match = "llm" if judge is not None else "substring"
        summary = await evaluator.run(
            [EvalQuestion(q["question"], q["expected_answer"], match=match) for q in questions]
        )

        async def retrieve(question):
            return await services.document_service.retrieve_chunks(
                question, auth, k=4, use_colpali=use_colpali
            )

        cases = [
            RetrievalCase(q["question"],
                          [by_name[n] for n in q.get("gold_docs", []) if n in by_name],
                          q["expected_answer"])
            for q in questions
        ]
        retrieval = await evaluate_retrieval(cases, retrieve, k=4)
        if services.colpali_vector_store is not None:
            services.colpali_vector_store.close()
        return {
            "accuracy": summary["accuracy"],
            "n_questions": summary["n_questions"],
            "avg_latency_s": summary["avg_latency_s"],
            "avg_answer_chars": summary["avg_answer_chars"],
            "recall_at_4": retrieval["recall_at_k"],
            "mrr": retrieval["mrr"],
            "context_precision": retrieval["context_precision"],
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=Path, default=None)
    ap.add_argument("--questions", type=Path, default=None)
    ap.add_argument("--use-colpali", action="store_true", default=False)
    ap.add_argument("--out", type=Path, default=None, help="write the summary JSON artifact here")
    ap.add_argument("--judge-api-base", default=None)
    ap.add_argument("--judge-model", default=None)
    ap.add_argument("--judge-api-key", default=None)
    ap.add_argument("--cpu", action="store_true", help="run the services on the CPU (default: the card)")
    args = ap.parse_args(argv)
    judge, judge_desc = build_judge(args)

    if args.corpus:
        corpus_dir = args.corpus
        questions = json.loads(args.questions.read_text()) if args.questions else []
    else:
        tmp = Path(tempfile.mkdtemp())
        for name, text in BUILTIN_CORPUS.items():
            (tmp / name).write_text(text)
        corpus_dir, questions = tmp, BUILTIN_QUESTIONS

    out = asyncio.run(run_eval(corpus_dir, questions, args.use_colpali, judge=judge,
                               device="cpu" if args.cpu else None))
    print(json.dumps(out))
    if args.out:
        artifact = {
            "benchmark": str(corpus_dir),
            "n_documents": len(list(Path(corpus_dir).glob("*"))),
            "use_colpali": args.use_colpali,
            "judge": judge_desc,
            **out,
        }
        args.out.write_text(json.dumps(artifact, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
