"""LZW decoding for GIF and TIFF page images, in the stdlib.

One decoder, two settings:

- GIF (Pillow's `GifDecode.c`): codes packed least significant bit
  first, starting one bit wider than the minimum code size, a clear code
  `1 << min_size` and an end code one above it; the code width grows when
  the next free code reaches `1 << width`, up to 12 bits, and a full
  table (4096 codes) is kept until the encoder sends a clear ("deferred
  clear"): later codes add no entry.
- TIFF (libtiff's `tif_lzw.c`): codes packed most significant bit first,
  9 to 12 bits, clear 256 and end of information 257, with the "early
  change" of the TIFF 6.0 specification: the width grows one code sooner,
  when the next free code reaches `(1 << width) - 1`.

A code above the next free one is a broken stream: `ValueError`. Data
that ends without an end code returns what was decoded, as both
libraries leave the rest of the image as it was.
"""

from __future__ import annotations


def _decode(data: bytes, min_size: int, msb: bool, early: int, limit: int) -> bytes:
    clear = 1 << min_size
    end = clear + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    width = min_size + 1
    out = []
    total = 0
    prev = None
    acc = nacc = 0
    pos = 0
    n = len(data)
    while total < limit:
        while nacc < width:
            if pos >= n:
                return b"".join(out)
            if msb:
                acc = (acc << 8) | data[pos]
            else:
                acc |= data[pos] << nacc
            pos += 1
            nacc += 8
        if msb:
            nacc -= width
            code = (acc >> nacc) & ((1 << width) - 1)
            acc &= (1 << nacc) - 1
        else:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nacc -= width
        if code == clear:
            del table[end + 1:]
            width = min_size + 1
            prev = None
            continue
        if code == end:
            break
        size = len(table)
        if prev is None:
            if code >= clear:
                raise ValueError("broken LZW stream: a string code right after a clear")
            entry = table[code]
        elif code < size:
            entry = table[code]
            if size < 4096:
                table.append(prev + entry[:1])
        elif code == size and size < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("broken LZW stream: a code past the table")
        out.append(entry)
        total += len(entry)
        prev = entry
        if len(table) + early >= (1 << width) and width < 12:
            width += 1
    return b"".join(out)


def decode_gif_lzw(data: bytes, min_size: int, limit: int) -> bytes:
    """A GIF frame's LZW data (its sub-blocks joined) -> up to `limit`
    palette indices."""
    if not 1 <= min_size <= 11:
        raise ValueError(f"GIF LZW minimum code size {min_size} out of range")
    return _decode(data, min_size, msb=False, early=0, limit=limit)


def decode_tiff_lzw(data: bytes, limit: int) -> bytes:
    """A TIFF strip or tile compressed with LZW (compression 5) -> up to
    `limit` bytes."""
    if data[:1] == b"\x00" and len(data) > 1 and data[1] & 1:
        raise ValueError("old-style (LSB-first) TIFF LZW is not decoded")
    return _decode(data, 8, msb=True, early=1, limit=limit)
