"""LLM answer judge, the port's copy of `evaluations/judge.py` (reference evaluations/custom_eval uses an LLM judge
for its 45-question financial benchmark). Works against any
OpenAI-compatible chat endpoint; falls back to substring matching when no
endpoint is configured (this build environment has no egress)."""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.request
from typing import Optional

logger = logging.getLogger(__name__)

JUDGE_PROMPT = (
    "You are grading a RAG system's answer.\n"
    "Question: {question}\n"
    "Expected answer: {expected}\n"
    "System answer: {answer}\n\n"
    'Does the system answer contain the expected information? Reply with JSON: {{"correct": true/false}}'
)


class LLMJudge:
    def __init__(
        self,
        api_base: Optional[str] = None,
        model: str = "gpt-4o-mini",
        api_key: Optional[str] = None,
        timeout_s: float = 60.0,
    ):
        self.api_base = api_base.rstrip("/") if api_base else None
        self.model = model
        self.api_key = api_key
        self.timeout_s = timeout_s

    def _chat_sync(self, prompt: str) -> str:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        body = json.dumps(
            {"model": self.model, "messages": [{"role": "user", "content": prompt}],
             "temperature": 0.0}
        ).encode()
        req = urllib.request.Request(f"{self.api_base}/chat/completions", data=body, headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            out = json.loads(resp.read())
        return out["choices"][0]["message"]["content"]

    async def __call__(self, question: str, expected: str, answer: str) -> bool:
        if not self.api_base:
            return expected.strip().lower() in answer.lower()
        prompt = JUDGE_PROMPT.format(question=question, expected=expected, answer=answer)
        try:
            text = await asyncio.to_thread(self._chat_sync, prompt)
            m = json.loads(text[text.index("{") : text.rindex("}") + 1])
            return bool(m.get("correct"))
        except Exception as e:  # noqa: BLE001
            logger.warning("LLM judge failed (%s); falling back to substring", e)
            return expected.strip().lower() in answer.lower()
