"""Completion layer of the port: `BaseCompletionModel` and the offline
`StubCompletionModel`, copies of `morphik_core_tpu/completion/models.py:37-121`.

The reference's network providers (`completion/models.py:124-450`) are
not ported yet (ROADMAP Queue 1 item 3g):
`build_completion_model` serves `completion.model = "stub"` and raises
for any other key.
"""

from __future__ import annotations

import json
import re
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, List

from morphik_core_tpu_torch.models.schemas import CompletionRequest, CompletionResponse


def _is_image_content(chunk: str) -> bool:
    return chunk.startswith("data:image/")


class BaseCompletionModel(ABC):
    @abstractmethod
    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        ...

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        """Default streaming: yield the non-streaming completion at once."""
        resp = await self.complete(request)
        yield resp.completion if isinstance(resp.completion, str) else json.dumps(resp.completion)


class StubCompletionModel(BaseCompletionModel):
    """Extractive offline answerer: returns the most question-relevant
    sentences from the context (word-overlap scored)."""

    def __init__(self, model_name: str = "stub"):
        self.model_name = model_name

    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        texts = [c for c in request.context_chunks if not _is_image_content(c)]
        n_images = len(request.context_chunks) - len(texts)
        q_words = set(re.findall(r"[a-z0-9]+", request.query.lower()))
        sentences: List[tuple] = []
        for t in texts:
            for s in re.split(r"(?<=[.!?])\s+|\n", t):
                words = set(re.findall(r"[a-z0-9]+", s.lower()))
                overlap = len(q_words & words)
                if s.strip():
                    sentences.append((overlap, s.strip()))
        sentences.sort(key=lambda x: -x[0])
        best = [s for _, s in sentences[:3] if _]
        if request.response_schema:
            props = (request.response_schema.get("properties") or {}).keys()
            completion: Any = {p: (best[0] if best else "") for p in props}
        elif best:
            completion = " ".join(best)
        else:
            completion = (
                f"[offline-stub] No matching context found for: {request.query!r} "
                f"({len(texts)} text chunks, {n_images} image chunks retrieved)"
            )
        tokens_in = sum(len(t.split()) for t in texts) + len(request.query.split())
        return CompletionResponse(
            completion=completion,
            usage={"prompt_tokens": tokens_in, "completion_tokens": len(str(completion).split()),
                   "total_tokens": tokens_in + len(str(completion).split())},
            finish_reason="stop",
            metadata={"model": self.model_name},
        )

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        resp = await self.complete(request)
        text = resp.completion if isinstance(resp.completion, str) else json.dumps(resp.completion)
        for i in range(0, len(text), 24):
            yield text[i : i + 24]


def build_completion_model(model_key: str) -> BaseCompletionModel:
    """The completion model of `completion.model`: the offline stub. Any
    other key raises: the reference routes it to a network provider (or,
    unregistered in development, to the stub with a warning), and the
    providers are not ported (ROADMAP Queue 1 item 3g)."""
    if model_key != "stub":
        raise NotImplementedError(
            f"completion model {model_key!r}: only completion.model='stub' is ported "
            "(network providers: ROADMAP Queue 1 item 3g)"
        )
    return StubCompletionModel(model_name=model_key)
