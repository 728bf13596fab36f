"""Host-side text helpers: port of `morphik_core_tpu/utils/fast_ops.py`
(`:56-102`) in pure Python.

The data-URI helpers run on the stdlib codec and `clean_control_chars`
on the reference's regex path (`:92-99`): its native library gives the
same bytes on both, and the port does not load it.
"""

from __future__ import annotations

import base64 as _b64
import re


def encode_base64(data: bytes) -> str:
    return _b64.b64encode(data).decode("ascii")


def decode_base64(s: str | bytes) -> bytes:
    if isinstance(s, str):
        s = s.encode("ascii")
    return _b64.b64decode(s)


def bytes_to_data_uri(data: bytes, mime_type: str = "image/png") -> str:
    return f"data:{mime_type};base64,{encode_base64(data)}"


def data_uri_to_bytes(uri: str) -> bytes:
    """Accepts both data URIs and raw base64 (the reference's contract)."""
    if uri.startswith("data:"):
        _, _, payload = uri.partition(",")
        return decode_base64(payload)
    return decode_base64(uri)


_CTRL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")


def clean_control_chars(text: str) -> str:
    """Drop C0 control characters but tab, newline and carriage return, and DEL."""
    return _CTRL_RE.sub("", text)
