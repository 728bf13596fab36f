"""CCITT fax decoding for bilevel TIFF pages, as libtiff's `tif_fax3.c`
decodes them, in the stdlib and numpy.

- Modified Huffman (TIFF compression 2): every row one-dimensional, no
  EOL codes, each row starting on a byte boundary (libtiff's
  `FAXMODE_BYTEALIGN` for CCITTRLE) as libtiff's bit reader counts it.
- T.4 (compression 3): every row after an EOL code, which
  `SYNC_EOL` finds past any fill bits (so byte-aligned EOLs too); with
  the T4Options bit 0 (2D coding) a tag bit after each EOL says whether
  the row is one-dimensional (1) or coded against the row above (0).
  Where `SYNC_EOL` reaches the end of the data without an EOL, libtiff
  4.6+ switches to `FAXMODE_NOEOL` for the rest of the image and decodes
  the strip's bits again from their start into the row it was on (the
  rows before keep what they had): rows follow each other with no EOL,
  each still opened by its tag bit in 2D, and an EOL met as data ends a
  row as any EOL inside a row does.
- T.6 / Group 4 (compression 4): every row two-dimensional, no EOLs, the
  first row coded against an imaginary white row.

Rows come out as libtiff's fax decoder writes them: bit 1 for a black
run, 0 for white, most significant bit first, each row padded to whole
bytes; the TIFF reader maps them through the photometric interpretation
as for an uncompressed 1-bit strip, and undoes FillOrder 2 on the
compressed bytes before they get here. The codes are those of ITU-T T.4
tables 1-3 (terminating, make-up and extended make-up codes for white
and black runs) and the T.4 / T.6 two-dimensional mode codes (pass,
horizontal, vertical 0, R1-R3, L1-L3), in libtiff's tables, where an EOL
is the eleven zeros before its one.

libtiff's bit reader is followed to the bit: at the end of the data a
lookup is padded with zero bits, which shifts the byte alignment of a
Modified Huffman row that follows. A code no table holds, an EOL inside
a row and uncompressed mode (an extension code, not decoded) end the row
as libtiff does, which reports them and goes on. Data that ends before
its rows raises `ValueError`, except in a Group 4 strip past its first
row, which libtiff takes as ended there, as it does at an EOL.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
    "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
    "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
    "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
    "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
    "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
    "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 "
    "000000101000 000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
    "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
               "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
# libtiff's tables (`mkg3states.c`) hold an EOL as eleven zeros in the run
# tables and seven in the mode table, whose next four bits the decoder
# reads apart; what follows the zeros is left to `SYNC_EOL`
_EOL_RUN, _EOL_MODE = "0" * 11, "0" * 7

# two-dimensional modes: (code, kind, vertical offset)
_P, _H, _V, _X, _E = range(5)
_MODES = [("0001", _P, 0), ("001", _H, 0), ("1", _V, 0), ("011", _V, 1), ("000011", _V, 2),
          ("0000011", _V, 3), ("010", _V, -1), ("000010", _V, -2), ("0000010", _V, -3),
          ("0000001", _X, 0), (_EOL_MODE, _E, 0)]

_TERM, _MAKEUP, _EOLK = 0, 1, 2
# how a run's codes end: a terminating code, an EOL, a code no table holds
_OK, _AT_EOL, _BAD = range(3)


def _table(bits: int, codes) -> List[int]:
    """A `bits`-wide peek -> kind << 24 | run << 8 | length (0: no code)."""
    table = [0] * (1 << bits)
    for code, kind, value in codes:
        n = len(code)
        base = int(code, 2) << (bits - n)
        entry = kind << 24 | (value & 0xFFFF) << 8 | n
        for i in range(1 << (bits - n)):
            assert table[base + i] == 0, code
            table[base + i] = entry
    return table


def _run_codes(term, makeup):
    out = [(c, _TERM, i) for i, c in enumerate(term)]
    out += [(c, _MAKEUP, 64 * (i + 1)) for i, c in enumerate(makeup)]
    out += [(c, _MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
    return out + [(_EOL_RUN, _EOLK, 0)]


_WHITE = _table(12, _run_codes(_WHITE_TERM, _WHITE_MAKEUP))
_BLACK = _table(13, _run_codes(_BLACK_TERM, _BLACK_MAKEUP))
_MODE = _table(7, [(c, k, v + 3) for c, k, v in _MODES])


class _EOF(Exception):
    """The data ended before a lookup had a bit; `runs` is the row so far,
    closed at its width."""
    runs: List[int] = []


class _Bits:
    """libtiff's bit reader (`BitAcc`, `BitsAvail`, `NeedBits16`): bytes
    are loaded as lookups need them; at the end of the data a lookup that
    still holds some bits is padded with zero bits, which then count as
    held, and one that holds none raises `_EOF`. `align` drops the held
    bits past a multiple of 8, so after padding it lands off the byte
    grid, as libtiff's does."""
    __slots__ = ("data", "n", "loaded", "avail", "pos")

    def __init__(self, data: bytes):
        self.n = len(data)
        self.data = bytes(data) + b"\x00\x00"
        self.loaded = self.avail = self.pos = 0

    def need(self, k: int) -> None:
        while self.avail < k:
            if self.loaded >= self.n:
                if not self.avail:
                    raise _EOF
                self.avail = k
            else:
                self.loaded += 1
                self.avail += 8

    def peek(self, n: int) -> int:
        """The next `n` bits; zeros past the data."""
        p = self.pos
        i = p >> 3
        if i >= self.n:
            return 0
        v = (self.data[i] << 16) | (self.data[i + 1] << 8) | self.data[i + 2]
        return (v >> (24 - n - (p & 7))) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n
        self.avail -= n

    def take(self, table: List[int], bits: int) -> int:
        """`LOOKUP16`: the entry of the next code (0, taking no bits, where
        no code matches)."""
        if self.avail < bits:
            self.need(bits)
        e = table[self.peek(bits)]
        self.pos += e & 0xFF
        self.avail -= e & 0xFF
        return e

    def align(self) -> None:
        self.skip(self.avail & 7)


class _Row:
    """libtiff's run array for one row: run lengths, white first, built by
    `SETVALUE` (a run is what the pass modes carried plus its own length)."""
    __slots__ = ("runs", "a0", "carry")

    def __init__(self):
        self.runs: List[int] = []
        self.a0 = 0
        self.carry = 0

    def set(self, x: int) -> None:
        self.runs.append(self.carry + x)
        self.a0 += x
        self.carry = 0

    def run(self, br: _Bits, black: bool) -> int:
        """Make-up codes then a terminating code (_OK), or _AT_EOL / _BAD
        where an EOL or no code comes first."""
        table, bits = (_BLACK, 13) if black else (_WHITE, 12)
        while True:
            e = br.take(table, bits)
            if not e:
                return _BAD
            kind = e >> 24
            if kind == _EOLK:
                return _AT_EOL
            if kind == _TERM:
                self.set((e >> 8) & 0xFFFF)
                return _OK
            self.a0 += (e >> 8) & 0xFFFF
            self.carry += (e >> 8) & 0xFFFF

    def cleanup(self, width: int) -> List[int]:
        """`CLEANUP_RUNS`: close the row at exactly `width`."""
        if self.carry:
            self.set(0)
        if self.a0 != width:
            while self.a0 > width and self.runs:
                self.a0 -= self.runs.pop()
            if self.a0 < width:
                self.a0 = max(self.a0, 0)
                if len(self.runs) & 1:
                    self.set(0)
                self.set(width - self.a0)
            elif self.a0 > width:
                self.set(width)
                self.set(0)
        return self.runs


def _row_1d(br: _Bits, width: int) -> Tuple[List[int], bool]:
    """`EXPAND1D`: alternate white and black runs up to the row's end, or
    to an EOL or a bad code. -> (runs, whether an EOL ended the row)."""
    row = _Row()
    black = False
    try:
        while True:
            status = row.run(br, black)
            if status != _OK or row.a0 >= width:
                break
            if black and len(row.runs) >= 2 and row.runs[-1] == 0 and row.runs[-2] == 0:
                del row.runs[-2:]
            black = not black
    except _EOF as eof:
        eof.runs = row.cleanup(width)
        raise
    return row.cleanup(width), status == _AT_EOL


def _row_2d(br: _Bits, width: int, ref: List[int]) -> Tuple[List[int], bool]:
    """`EXPAND2D`: a row coded against the run array of the row above
    (`ref`, closed by a zero run). A bad code ends the row; an EOL or an
    extension code ends it in the colour it has at that point. -> (runs,
    whether an EOL ended the row)."""
    ref = ref + [0] * 4
    row = _Row()
    b1, pb = ref[0], 1
    eol = False

    def check_b1():
        nonlocal b1, pb
        if row.runs:
            while b1 <= row.a0 and b1 < width:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2

    try:
        while row.a0 < width:
            if pb + 2 >= len(ref):
                ref += [0] * 4
            e = br.take(_MODE, 7)
            kind, value = e >> 24, ((e >> 8) & 0xFFFF) - 3
            if kind == _P:
                check_b1()
                b1 += ref[pb]
                pb += 1
                row.carry += b1 - row.a0
                row.a0 = b1
                b1 += ref[pb]
                pb += 1
            elif kind == _H:
                black = bool(len(row.runs) & 1)
                if row.run(br, black) != _OK or row.run(br, not black) != _OK:
                    break
                check_b1()
            elif kind == _V:
                check_b1()
                if value < 0 and b1 < row.a0 - value:
                    break
                row.set(b1 - row.a0 + value)
                if value < 0:
                    pb -= 1
                    b1 -= ref[pb]
                else:
                    b1 += ref[pb]
                    pb += 1
            else:
                row.runs.append(width - row.a0)
                if kind == _E:
                    br.need(4)
                    br.skip(4)
                    eol = True
                break
        else:
            if row.carry and row.carry + row.a0 < width:
                # a final V0 closes what the pass modes carried; without
                # one the row ends as at a bad code
                br.need(1)
                if br.peek(1) == 1:
                    br.skip(1)
    except _EOF as eof:
        eof.runs = row.cleanup(width)
        raise
    return row.cleanup(width), eol


def _sync_eol(br: _Bits, after_eol: bool) -> None:
    """libtiff's `SYNC_EOL`: skip to eleven zero bits (unless the row
    before ended on an EOL's zeros), then past the zeros and the one that
    ends the EOL."""
    if not after_eol:
        while True:
            br.need(11)
            if br.peek(11) == 0:
                break
            br.skip(1)
    while True:
        br.need(8)
        if br.peek(8):
            break
        br.skip(8)
    while br.peek(1) == 0:
        br.skip(1)
    br.skip(1)


def _fill(rows: np.ndarray, r: int, runs: List[int], width: int) -> None:
    """libtiff's `_TIFFFax3fillruns`: odd runs are black."""
    x = 0
    for k, n in enumerate(runs):
        if k & 1 and n:
            rows[r, x:min(x + n, width)] = 1
        x += n


def decode_ccitt(data: bytes, width: int, height: int, compression: int, t4options: int = 0,
                 held: Optional[bytes] = None, mode: Optional[dict] = None) -> bytes:
    """One strip or tile of CCITT data -> `height` rows of `width` bits,
    packed most significant bit first, each row padded to whole bytes.
    The rows a Group 4 strip leaves undecoded, where it ends early, keep
    what `held` has there: the packed rows the reader's strip buffer held
    before (zeros where it is None or short). `mode` carries libtiff's
    decoder mode from one strip of an image to the next: a T.4 strip
    where `SYNC_EOL` finds no EOL sets `noeol` (libtiff 4.6+:
    `FAXMODE_NOEOL`), and from then on no row of the image looks for one."""
    if compression == 3 and t4options & 2:
        raise ValueError("CCITT T.4 with uncompressed mode is not decoded")
    if compression not in (2, 3, 4):
        raise ValueError(f"not a CCITT compression: {compression}")
    mode = {} if mode is None else mode
    br = _Bits(data)
    rows = np.zeros((height, width), np.uint8)
    ref: List[int] = [width, 0]
    eol = False
    done = height
    for r in range(height):
        try:
            if compression == 2:
                runs, _ = _row_1d(br, width)
                br.align()
            elif compression == 3:
                if not mode.get("noeol"):
                    try:
                        _sync_eol(br, eol)
                    except _EOF:
                        # no EOL before the data ends: the strip's bits again from their start, without
                        # EOLs, into this row and the ones after it
                        mode["noeol"] = True
                        br = _Bits(data)
                one_d = True
                if t4options & 1:
                    br.need(1)
                    one_d = br.peek(1) == 1
                    br.skip(1)
                runs, eol = _row_1d(br, width) if one_d else _row_2d(br, width, ref)
            else:
                runs, eol = _row_2d(br, width, ref)
        except _EOF as eof:
            if compression != 4 or r == 0:
                raise ValueError("CCITT data ends before its rows") from None
            runs, eol = eof.runs, True
        _fill(rows, r, runs, width)
        if compression == 4 and eol:
            # `Fax4Decode` takes the strip as ended ("don't error on
            # badly-terminated strips"), unless it is still on its first row
            if r == 0:
                raise ValueError("CCITT Group 4 data ends on its first row")
            done = r + 1
            break
        ref = runs + [0]
    out = np.packbits(rows, axis=1)
    if done < height and held:
        rest = np.frombuffer(held[:out.size].ljust(out.size, b"\0"), np.uint8).reshape(out.shape)
        out[done:] = rest[done:]
    return out.tobytes()
