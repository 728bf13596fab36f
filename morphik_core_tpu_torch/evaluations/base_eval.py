"""Evaluation harness, the port's copy of `evaluations/base_eval.py`
(reference evaluations/custom_eval/base_eval.py):
pluggable RAG evaluators — ingest a corpus, ask questions, judge answers.

Judging providers:
  - exact/substring matching (offline deterministic);
  - optional LLM judge through any OpenAI-compatible endpoint
    (the reference uses an LLM judge for its 45-question financial
    benchmark, custom_eval/README.md).
"""

from __future__ import annotations

import abc
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class EvalQuestion:
    question: str
    expected_answer: str
    match: str = "substring"  # substring | exact | llm
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvalResult:
    question: str
    expected: str
    answer: str
    correct: bool
    latency_s: float
    sources: List[Dict[str, Any]] = field(default_factory=list)


class BaseRAGEvaluator(abc.ABC):
    """Subclass and implement ingest() + answer() for the system under test."""

    def __init__(self, judge=None):
        self.judge = judge  # optional async (question, expected, answer) -> bool

    @abc.abstractmethod
    async def ingest(self, corpus_dir: Path) -> None:
        ...

    @abc.abstractmethod
    async def answer(self, question: str) -> tuple[str, List[Dict[str, Any]]]:
        ...

    async def _is_correct(self, q: EvalQuestion, answer: str) -> bool:
        if q.match == "exact":
            return answer.strip().lower() == q.expected_answer.strip().lower()
        if q.match == "llm" and self.judge is not None:
            return await self.judge(q.question, q.expected_answer, answer)
        return q.expected_answer.strip().lower() in answer.lower()

    async def run(self, questions: List[EvalQuestion], out_path: Optional[Path] = None) -> Dict[str, Any]:
        results: List[EvalResult] = []
        for q in questions:
            t0 = time.perf_counter()
            try:
                answer, sources = await self.answer(q.question)
            except Exception as e:  # noqa: BLE001
                answer, sources = f"[error: {e}]", []
            latency = time.perf_counter() - t0
            correct = await self._is_correct(q, answer)
            results.append(EvalResult(q.question, q.expected_answer, str(answer), correct, latency, sources))
        accuracy = sum(r.correct for r in results) / max(len(results), 1)
        summary = {
            "accuracy": accuracy,
            "n_questions": len(results),
            "n_correct": sum(r.correct for r in results),
            "avg_latency_s": sum(r.latency_s for r in results) / max(len(results), 1),
            "avg_answer_chars": sum(len(r.answer) for r in results) / max(len(results), 1),
            "results": [r.__dict__ for r in results],
        }
        if out_path:
            Path(out_path).write_text(json.dumps(summary, indent=2, default=str))
        logger.info("eval accuracy %.2f%% (%d/%d)", accuracy * 100, summary["n_correct"], len(results))
        return summary


class MorphikTPUEvaluator(BaseRAGEvaluator):
    """Evaluator driving the in-process services (no HTTP): the port's
    `build_services(...)`, whose ingestion and document services take the
    reference's calls."""

    def __init__(self, services, auth, use_colpali: bool = True, k: int = 4, judge=None):
        super().__init__(judge=judge)
        self.services = services
        self.auth = auth
        self.use_colpali = use_colpali
        self.k = k

    async def ingest(self, corpus_dir: Path) -> None:
        for f in sorted(Path(corpus_dir).glob("*")):
            if not f.is_file():
                continue
            doc = await self.services.ingestion_service.ingest_file_content(
                f.read_bytes(), f.name, {}, self.auth, use_colpali=self.use_colpali
            )
            await self.services.ingestion_service.process_ingestion_job(
                doc.external_id, self.auth, self.use_colpali
            )

    async def answer(self, question: str):
        resp = await self.services.document_service.query(
            question, self.auth, k=self.k, use_colpali=self.use_colpali
        )
        return str(resp.completion), resp.sources
