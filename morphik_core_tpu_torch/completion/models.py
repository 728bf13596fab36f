"""Completion layer of the port: a copy of
`morphik_core_tpu/completion/models.py` over the stdlib transport
(`completion/_http.py`) where the reference uses httpx.

Providers:
  - OpenAICompatCompletionModel: any OpenAI-compatible /chat/completions
    endpoint. Image chunks (data URIs) go as image_url blocks; streaming
    reads the SSE `data:` lines up to `[DONE]`.
  - OllamaNativeCompletionModel: Ollama's native /api/chat, images as a
    raw-base64 `images` list, `format: "json"` for structured output,
    NDJSON streaming.
  - AnthropicCompletionModel: /v1/messages with x-api-key and
    anthropic-version, images as base64 source blocks, SSE
    content_block_delta streaming up to `message_stop`.
  - StubCompletionModel: a deterministic offline answerer that quotes
    the most question-relevant sentences of the context.

Structured output (`response_schema`) is a JSON-schema instruction and a
parse of the answer (code fences stripped); an answer that does not
parse comes back as its text. A provider that answers 4xx/5xx raises.
`build_completion_model` routes a `registered_models` entry to its
provider as the reference does, and outside `development` refuses to
serve the stub for a key it cannot route.
"""

from __future__ import annotations

import json
import logging
import re
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from morphik_core_tpu_torch.completion._http import post_json, stream_lines
from morphik_core_tpu_torch.models.schemas import CompletionRequest, CompletionResponse

logger = logging.getLogger(__name__)

DEFAULT_PROMPT = (
    "You are a helpful assistant. Answer the question using ONLY the provided context.\n"
    "Context:\n{context}\n\nQuestion: {question}"
)
SCHEMA_INSTRUCTION = "Respond ONLY with JSON matching this schema:\n"

# media subtypes carry '+', '-', '.' (image/svg+xml, ...)
_DATA_URI_RE = re.compile(r"^data:(image/[\w.+-]+);base64,(.*)$", re.S)


def _is_image_content(chunk: str) -> bool:
    return chunk.startswith("data:image/")


def _prompt_and_images(request: CompletionRequest) -> Tuple[str, List[str]]:
    """The filled prompt template (text chunks as its context) and the
    image chunks. A plain placeholder substitution, not `str.format`: a
    user template may hold literal braces (JSON examples)."""
    texts = [c for c in request.context_chunks if not _is_image_content(c)]
    images = [c for c in request.context_chunks if _is_image_content(c)]
    template = request.prompt_template or DEFAULT_PROMPT
    prompt = template.replace("{context}", "\n---\n".join(texts)).replace("{question}", request.query)
    return prompt, images


def _history(request: CompletionRequest) -> List[Dict[str, Any]]:
    return [{"role": m.role, "content": m.content} for m in request.chat_history or []]


def _structured(text: str, request: CompletionRequest, provider: str) -> Any:
    """The answer's JSON when a schema was asked for and it parses, else its text."""
    if not request.response_schema:
        return text
    try:
        return json.loads(re.sub(r"^```(json)?|```$", "", text.strip(), flags=re.M))
    except (json.JSONDecodeError, TypeError):
        logger.warning("%sstructured output parse failed; returning raw text", provider)
        return text


class BaseCompletionModel(ABC):
    @abstractmethod
    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        ...

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        """Default streaming: yield the non-streaming completion at once."""
        resp = await self.complete(request)
        yield resp.completion if isinstance(resp.completion, str) else json.dumps(resp.completion)

    def _build_messages(self, request: CompletionRequest) -> List[Dict[str, Any]]:
        """OpenAI-style messages: the history, then the prompt (with
        image_url blocks when the context holds images); a schema
        instruction first as a system message."""
        prompt, images = _prompt_and_images(request)
        messages = _history(request)
        if images:
            content: List[Dict[str, Any]] = [{"type": "text", "text": prompt}]
            content.extend({"type": "image_url", "image_url": {"url": u}} for u in images)
            messages.append({"role": "user", "content": content})
        else:
            messages.append({"role": "user", "content": prompt})
        if request.response_schema:
            messages.insert(0, {"role": "system", "content": SCHEMA_INSTRUCTION + json.dumps(request.response_schema)})
        return messages


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


class OpenAICompatCompletionModel(BaseCompletionModel):
    def __init__(
        self,
        base_url: str,
        model: str,
        api_key: Optional[str] = None,
        timeout: float = 120.0,
        extra_params: Optional[Dict[str, Any]] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout
        self.extra_params = extra_params or {}

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _payload(self, request: CompletionRequest, stream: bool = False) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": self._build_messages(request),
            "stream": stream,
            **self.extra_params,
        }
        if request.max_tokens:
            payload["max_tokens"] = request.max_tokens
        if request.temperature is not None:
            payload["temperature"] = request.temperature
        if request.llm_config:
            payload.update({k: v for k, v in request.llm_config.items() if k not in ("model",)})
            if request.llm_config.get("model"):
                payload["model"] = request.llm_config["model"]
        return payload

    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        data = await post_json(f"{self.base_url}/chat/completions", self._payload(request), self._headers(),
                               self.timeout)
        text = data["choices"][0]["message"]["content"]
        return CompletionResponse(
            completion=_structured(text, request, ""),
            usage=data.get("usage", {}),
            finish_reason=data["choices"][0].get("finish_reason"),
            metadata={"model": data.get("model", self.model)},
        )

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        lines = stream_lines(f"{self.base_url}/chat/completions", self._payload(request, stream=True),
                             self._headers(), self.timeout)
        try:
            async for line in lines:
                if not line.startswith("data: "):
                    continue
                payload = line[6:]
                if payload.strip() == "[DONE]":
                    break
                try:
                    delta = json.loads(payload)["choices"][0]["delta"].get("content")
                except (json.JSONDecodeError, KeyError, IndexError):
                    continue
                if delta:
                    yield delta
        finally:
            await lines.aclose()


class OllamaNativeCompletionModel(BaseCompletionModel):
    """Ollama's native /api/chat protocol (not its OpenAI shim): images
    ride as a raw-base64 `images` list on the user message and structured
    output uses `format: "json"`."""

    def __init__(
        self,
        base_url: str,
        model: str,
        timeout: float = 120.0,
        extra_options: Optional[Dict[str, Any]] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout
        self.extra_options = extra_options or {}

    @staticmethod
    def _raw_b64(uri: str) -> str:
        """The base64 payload of a data URI (Ollama wants no prefix)."""
        m = _DATA_URI_RE.match(uri)
        if m:
            return m.group(2)
        if uri.startswith("data:") and "," in uri:  # another data: flavour: still strip the header
            return uri.split(",", 1)[1]
        return uri

    def _payload(self, request: CompletionRequest, stream: bool) -> Dict[str, Any]:
        prompt, images = _prompt_and_images(request)
        messages: List[Dict[str, Any]] = []
        if request.response_schema:
            messages.append({"role": "system", "content": SCHEMA_INSTRUCTION + json.dumps(request.response_schema)})
        messages.extend(_history(request))
        user: Dict[str, Any] = {"role": "user", "content": prompt}
        if images:
            user["images"] = [self._raw_b64(u) for u in images]
        messages.append(user)
        options: Dict[str, Any] = dict(self.extra_options)
        if request.temperature is not None:
            options["temperature"] = request.temperature
        if request.max_tokens:
            options["num_predict"] = request.max_tokens
        payload: Dict[str, Any] = {"model": self.model, "messages": messages, "stream": stream, "options": options}
        if request.response_schema:
            payload["format"] = "json"
        if request.llm_config and request.llm_config.get("model"):
            payload["model"] = request.llm_config["model"]
        return payload

    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        data = await post_json(f"{self.base_url}/api/chat", self._payload(request, False), {}, self.timeout)
        text = (data.get("message") or {}).get("content", "")
        pt, ct = data.get("prompt_eval_count", 0), data.get("eval_count", 0)
        return CompletionResponse(
            completion=_structured(text, request, "ollama "),
            usage={"prompt_tokens": pt, "completion_tokens": ct, "total_tokens": pt + ct},
            finish_reason=data.get("done_reason", "stop"),
            metadata={"model": data.get("model", self.model)},
        )

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        lines = stream_lines(f"{self.base_url}/api/chat", self._payload(request, True), {}, self.timeout)
        try:
            async for line in lines:
                if not line.strip():
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if obj.get("done"):
                    break
                delta = (obj.get("message") or {}).get("content")
                if delta:
                    yield delta
        finally:
            await lines.aclose()


class AnthropicCompletionModel(BaseCompletionModel):
    """Anthropic /v1/messages payloads: x-api-key auth, the schema
    instruction as the top-level system field, images as base64 source
    blocks, SSE content_block_delta streaming."""

    API_VERSION = "2023-06-01"

    def __init__(
        self,
        model: str,
        api_key: Optional[str] = None,
        base_url: str = "https://api.anthropic.com",
        timeout: float = 120.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json", "anthropic-version": self.API_VERSION}
        if self.api_key:
            h["x-api-key"] = self.api_key
        return h

    def _payload(self, request: CompletionRequest, stream: bool) -> Dict[str, Any]:
        prompt, images = _prompt_and_images(request)
        content: List[Dict[str, Any]] = []
        for u in images:
            m = _DATA_URI_RE.match(u)
            if m:
                content.append({"type": "image",
                                "source": {"type": "base64", "media_type": m.group(1), "data": m.group(2)}})
            else:  # never drop evidence silently
                logger.warning("skipping non-base64 image chunk (%.40s...)", u)
        content.append({"type": "text", "text": prompt})
        messages = _history(request)
        messages.append({"role": "user", "content": content})
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": messages,
            "max_tokens": request.max_tokens or 1024,
            "stream": stream,
        }
        if request.temperature is not None:
            payload["temperature"] = request.temperature
        if request.response_schema:
            payload["system"] = SCHEMA_INSTRUCTION + json.dumps(request.response_schema)
        if request.llm_config and request.llm_config.get("model"):
            payload["model"] = request.llm_config["model"]
        return payload

    async def complete(self, request: CompletionRequest) -> CompletionResponse:
        data = await post_json(f"{self.base_url}/v1/messages", self._payload(request, False), self._headers(),
                               self.timeout)
        text = "".join(b.get("text", "") for b in data.get("content", []) if b.get("type") == "text")
        usage = data.get("usage", {})
        pt, ct = usage.get("input_tokens", 0), usage.get("output_tokens", 0)
        return CompletionResponse(
            completion=_structured(text, request, "anthropic "),
            usage={"prompt_tokens": pt, "completion_tokens": ct, "total_tokens": pt + ct},
            finish_reason=data.get("stop_reason"),
            metadata={"model": data.get("model", self.model)},
        )

    async def complete_stream(self, request: CompletionRequest) -> AsyncIterator[str]:
        lines = stream_lines(f"{self.base_url}/v1/messages", self._payload(request, True), self._headers(),
                             self.timeout)
        try:
            async for line in lines:
                if not line.startswith("data: "):
                    continue
                try:
                    obj = json.loads(line[6:])
                except json.JSONDecodeError:
                    continue
                if obj.get("type") == "content_block_delta":
                    delta = obj.get("delta", {}).get("text")
                    if delta:
                        yield delta
                elif obj.get("type") == "message_stop":
                    break
        finally:
            await lines.aclose()


def build_completion_model(
    registered: Dict[str, Dict[str, Any]],
    model_key: str,
    environment: str = "development",
) -> BaseCompletionModel:
    """The provider of a `registered_models` entry:
      - provider="ollama" (or model_name "ollama/..." / "ollama_chat/...")
        -> native /api/chat with raw-base64 `images`;
      - provider="anthropic" (or model_name "anthropic/..." / "claude...")
        -> /v1/messages with x-api-key and base64 image source blocks;
      - any other api_base -> OpenAI-compatible /chat/completions;
      - nothing configured -> the offline stub, in development only.

    An api_base without an explicit provider keeps the OpenAI-compatible
    wire format whatever the model's name (a proxy such as openrouter
    serving "anthropic/..." names). Outside development, a key it cannot
    route refuses to boot rather than serve stub answers with HTTP 200."""
    cfg = registered.get(model_key, {})
    api_base = cfg.get("api_base")
    name = cfg.get("model_name", model_key)
    provider = cfg.get("provider")
    if provider is None:
        if api_base:
            provider = "openai"
        elif name.startswith(("ollama/", "ollama_chat/")):
            provider = "ollama"
        elif name.startswith("anthropic/") or name.startswith("claude"):
            provider = "anthropic"
    if provider == "ollama":
        return OllamaNativeCompletionModel(
            base_url=api_base or "http://localhost:11434",
            model=name.split("/", 1)[1] if "/" in name else name,
        )
    if provider == "anthropic":
        return AnthropicCompletionModel(
            model=name.split("/", 1)[1] if name.startswith("anthropic/") else name,
            api_key=cfg.get("api_key"),
            base_url=api_base or "https://api.anthropic.com",
        )
    if api_base:
        return OpenAICompatCompletionModel(base_url=api_base, model=name, api_key=cfg.get("api_key"))
    if environment != "development" and model_key != "stub":
        known = sorted(registered)
        raise RuntimeError(
            f"completion model {model_key!r} is "
            + ("not in registered_models" if model_key not in registered else "missing api_base")
            + f" (known keys: {known}); refusing to serve stub completions in "
            f"environment={environment!r} — set completion.model='stub' to opt in"
        )
    logger.warning("model %s has no api_base — using offline stub completion", model_key)
    return StubCompletionModel(model_name=model_key)
