"""Content-type detection + the ColPali-native gate: copy of
`morphik_core_tpu/storage/content_types.py`.

Mirrors reference core/storage/utils_file_extensions.py: magic-byte
sniffing + filename extension + text heuristic, and the
`is_colpali_native_format` gate (image/* plus pdf/dicom/Word/PowerPoint)
that decides whether text parsing is skipped at ingest (ref :8-18,75-80).
"""

from __future__ import annotations

import mimetypes
from typing import Optional

_MAGIC = [
    (b"%PDF", "application/pdf"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"BM", "image/bmp"),
    (b"II*\x00", "image/tiff"),
    (b"MM\x00*", "image/tiff"),
    (b"RIFF", None),  # webp/avi — refined below
    (b"PK\x03\x04", None),  # zip-based (docx/xlsx/pptx) — refined below
    (b"\xd0\xcf\x11\xe0", "application/msword"),
    (b"DICM", "application/dicom"),
]

DOCX = "application/vnd.openxmlformats-officedocument.wordprocessingml.document"
XLSX = "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"
PPTX = "application/vnd.openxmlformats-officedocument.presentationml.presentation"

COLPALI_NATIVE_MIME = {
    "application/pdf",
    "application/dicom",
    "application/msword",
    DOCX,
    "application/vnd.ms-powerpoint",
    PPTX,
}


def _sniff_zip_office(data: bytes, filename: Optional[str]) -> str:
    ext = (filename or "").lower().rsplit(".", 1)[-1] if filename and "." in filename else ""
    if ext == "docx":
        return DOCX
    if ext == "xlsx":
        return XLSX
    if ext == "pptx":
        return PPTX
    # peek into the zip directory
    if b"word/" in data[:4096]:
        return DOCX
    if b"xl/" in data[:4096]:
        return XLSX
    if b"ppt/" in data[:4096]:
        return PPTX
    return "application/zip"


def detect_content_type(data: bytes, filename: Optional[str] = None, hint: Optional[str] = None) -> str:
    for magic, mime in _MAGIC:
        if data[: len(magic)] == magic:
            if mime is not None:
                return mime
            if magic == b"PK\x03\x04":
                return _sniff_zip_office(data, filename)
            if magic == b"RIFF":
                if data[8:12] == b"WEBP":
                    return "image/webp"
                if data[8:12] == b"AVI ":
                    return "video/x-msvideo"
    if data[4:8] == b"ftyp":
        return "video/mp4"
    if hint and hint != "application/octet-stream":
        return hint
    if filename:
        guessed, _ = mimetypes.guess_type(filename)
        if guessed:
            return guessed
    # text sniff
    try:
        data[:2048].decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


def is_colpali_native_format(content_type: str) -> bool:
    """Formats rasterized straight to page images for the visual pipeline."""
    return content_type.startswith("image/") or content_type in COLPALI_NATIVE_MIME
