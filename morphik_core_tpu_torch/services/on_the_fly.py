"""One-shot document analysis without ingestion (`POST
/ingest/document/query`): port of `morphik_core_tpu/services/on_the_fly.py`.

The upload is parsed to text by the port's `MorphikParser` (the parser of
ingestion), and the text, cut to 200,000 characters, goes to the
configured completion model with the prompt and an optional
`response_schema` for structured output.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from morphik_core_tpu_torch.models.schemas import CompletionRequest

MAX_DOCUMENT_BYTES = 50 * 1024 * 1024
MAX_CONTEXT_CHARS = 200_000


class OnTheFlyError(Exception):
    """An upload the query cannot answer (empty, too large, unparsable, no text)."""


class OnTheFlyService:
    def __init__(self, parser, completion_model):
        self.parser = parser
        self.completion_model = completion_model

    async def query_document(
        self,
        file_bytes: bytes,
        filename: Optional[str],
        prompt: str,
        schema: Optional[Dict[str, Any]] = None,
        content_type: Optional[str] = None,
    ) -> Dict[str, Any]:
        """-> {completion, structured_output, usage, metadata}."""
        if not file_bytes:
            raise OnTheFlyError("uploaded file is empty")
        if len(file_bytes) > MAX_DOCUMENT_BYTES:
            raise OnTheFlyError(f"uploaded file exceeds limit of {MAX_DOCUMENT_BYTES // (1024 * 1024)} MB")
        try:
            _meta, text = await self.parser.parse_file_to_text(file_bytes, filename or "upload", content_type)
        except Exception as e:  # noqa: BLE001 — any parser failure is the upload's fault: a 400
            raise OnTheFlyError(f"failed to parse document: {e}") from e
        if not text.strip():
            raise OnTheFlyError("document produced no extractable text")
        request = CompletionRequest(query=prompt, context_chunks=[text[:MAX_CONTEXT_CHARS]], response_schema=schema)
        resp = await self.completion_model.complete(request)
        structured = resp.completion if (schema and not isinstance(resp.completion, str)) else None
        return {
            "completion": resp.completion,
            "structured_output": structured,
            "usage": resp.usage,
            "metadata": {"filename": filename, "parsed_chars": len(text)},
        }
