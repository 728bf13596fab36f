"""Data-URI helpers: port of `morphik_core_tpu/utils/fast_ops.py:56-90`
on the stdlib codec (the reference's native base64 gives the same
bytes; its build is not part of the port)."""

from __future__ import annotations

import base64 as _b64


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
