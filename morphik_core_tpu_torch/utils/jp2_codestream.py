"""JPEG 2000 headers: the JP2 boxes, the codestream's markers and its
tiles, as Pillow 12.1's `Jpeg2KImagePlugin` and OpenJPEG 2.5.4 read them.

`open_header(data)` is what `Jpeg2KImageFile._open` derives (size, mode,
palette) and needs only the headers; `parse(data)` reads the whole
codestream into a `Codestream`: SIZ, the coding and quantization styles
with OpenJPEG's precedence (a COD or QCD copies its values to every
component of the main header or of the tile, a COC or QCC then sets one
component, in the order they come), RGN, POC (appended per tile, layer
ends clipped to the layer count), PPM / PPT (their packet headers joined
in `Z` order), and each tile's tile-parts joined in order of appearance.
CAP, CPF, TLM, PLM, PLT, CRG, COM and the markers OpenJPEG does not know
are read past. A tile-part whose `Psot` is 0 runs to the end of the
codestream (less its EOC).

HTJ2K (Part 15) needs nothing of the headers but the code-block style
bit 0x40 (`Rsiz` and CAP are not read); the mixed style 0x80 fails, as
in OpenJPEG. Of Part 2, OpenJPEG 2.5.4 reads: CBD (each component's
precision and signedness, after SIZ has fixed its DC shift); MCT, MCC
and MCO, whose only effect with COD `mct` 0 or 1 is the DC level shift
(an MCO sets every component's to 0, then to the offset array of the
first MCC record when the stage names it and it spans every component);
COD `mct` 2 and wavelets past 5/3 and 9/7 fail. Each rule, and each
warning that leaves a marker unread, was held against `opj_decode`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# OpenJPEG's colour spaces (opj_image_t.color_space)
CS_UNSPECIFIED, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK = 0, 1, 2, 3, 4, 5
ENUMCS = {16: CS_SRGB, 17: CS_GRAY, 18: CS_SYCC, 24: CS_EYCC, 12: CS_CMYK}   # colr's others: unspecified

# code-block styles (COD / COC SPcod byte 3)
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM, HT, HT_MIXED = 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80


def accept(prefix: bytes) -> bool:
    return prefix[:4] == J2K_SIGNATURE or prefix[:12] == JP2_SIGNATURE


# ------------------------------------------------------------------ JP2 boxes


def _boxes(data: bytes, at: int, end: int, clip: bool = False):
    """(type, payload start, payload end) of each box in data[at:end]; a
    box of length 0 runs to `end`, and with `clip` so does one that claims
    more (the file's top level: Pillow reads no box past jp2h)."""
    while at + 8 <= end:
        lbox, tbox = struct.unpack(">I4s", data[at:at + 8])
        hlen = 8
        if lbox == 1:
            lbox = struct.unpack(">Q", data[at + 8:at + 16])[0]
            hlen = 16
        elif lbox == 0:
            lbox = end - at
        if clip and at + lbox > end >= at + hlen:
            lbox = end - at
        if lbox < hlen or at + lbox > end:
            raise NotThisFormat("Invalid header length")
        yield tbox, at + hlen, at + lbox
        at += lbox


@dataclass
class Jp2Header:
    """What the decode takes from a JP2's boxes: Pillow's size, mode and
    palette (`_parse_jp2_header`), the first colr box's enumeration
    (OpenJPEG's colour space; 0 without one) and the codestream box.
    Pillow decodes through OpenJPEG's tile API, which applies no pclr,
    cmap or cdef."""
    size: Tuple[int, int]
    mode: str
    palette: Optional[np.ndarray]
    enumcs: int
    codestream: Tuple[int, int]


def _pillow_jp2_header(data: bytes, jp2h: Tuple[int, int]):
    """`_parse_jp2_header`'s size, mode and palette from the jp2h box."""
    size = mode = nc = None
    palette = None
    for tbox, s, e in _boxes(data, *jp2h):
        if tbox == b"ihdr":
            if e - s < 11:
                raise NotThisFormat("Not enough data in header")
            height, width, nc, bpc = struct.unpack(">IIHB", data[s:s + 11])
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = struct.unpack(">BBBI", data[s:s + 7])
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack(">HB", data[s:s + 3])
            depths = data[s + 3:s + 3 + npc]
            if max(depths, default=0) <= 8:
                entries = np.frombuffer(data, np.uint8, ne * npc, s + 3 + npc).reshape(ne, npc)
                palette = _pillow_palette(entries)
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    return size, mode, palette


def _pillow_palette(entries: np.ndarray) -> np.ndarray:
    """`ImagePalette.getcolor` for each entry in turn: a colour already
    in the palette is not added again. -> (256, 3) uint8 (RGB columns;
    a fourth column, alpha, is dropped as `convert("RGB")` drops it)."""
    seen: Dict[Tuple[int, ...], int] = {}
    for row in entries:
        key = tuple(int(v) for v in row)
        if key not in seen:
            if len(seen) >= 256:
                raise ValueError("cannot allocate more than 256 colors")
            seen[key] = len(seen)
    pal = np.zeros((256, 3), np.uint8)
    for key, i in seen.items():
        rgb = key[:3] if len(key) >= 3 else (key + (0, 0, 0))[:3]
        pal[i] = rgb
    return pal


def _jp2_header(data: bytes) -> Jp2Header:
    jp2h = jp2c = None
    for tbox, s, e in _boxes(data, 12, len(data), clip=True):
        if tbox == b"jp2h" and jp2h is None:
            jp2h = (s, e)
            (lbox,) = struct.unpack(">I", data[s - 8:s - 4])   # Pillow reads the whole box: a cut one fails
            if lbox > 8 and s - 8 + lbox > len(data):
                raise ValueError(f"Expected to read {lbox - 8} bytes but only got {len(data) - s}.")
        elif tbox == b"jp2c":
            jp2c = (s, e)
            break
    if jp2h is None:
        raise NotThisFormat("Malformed JP2 header")
    size, mode, palette = _pillow_jp2_header(data, jp2h)
    enumcs = 0
    for tbox, s, e in _boxes(data, *jp2h):
        if tbox == b"colr":   # OpenJPEG keeps the first colr box
            if data[s] == 1 and e - s >= 7:
                enumcs = struct.unpack(">I", data[s + 3:s + 7])[0]
            break
    return Jp2Header(size, mode, palette, enumcs, jp2c)


def open_header(data: bytes):
    """`Jpeg2KImageFile._open`: -> (codec "j2k" / "jp2", (w, h), mode,
    palette); raises NotThisFormat where `_open` raises SyntaxError, and
    struct.error or IndexError where its walk for a comment
    (`_open_comment`) meets a cut marker."""
    if data[:4] == J2K_SIGNATURE:
        out = "j2k", *_pillow_codestream_header(data, 4), None
    elif data[:12] == JP2_SIGNATURE:
        h = _jp2_header(data)
        out = "jp2", h.size, h.mode, h.palette
    else:
        raise NotThisFormat("not a JPEG 2000 file")
    _open_comment(data)
    return out


def _pillow_codestream_header(data: bytes, at: int):
    """`_parse_codestream` on the bytes after SOC and SIZ's marker."""
    lsiz = struct.unpack(">H", data[at:at + 2])[0]
    siz = data[at:at + lsiz]
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise NotThisFormat("unable to determine J2K image mode")
    return size, mode


# -------------------------------------------------------------- codestream


@dataclass
class Tccp:
    """One component's coding and quantization style (OpenJPEG's opj_tccp_t)."""
    numres: int = 6
    cblkw: int = 6
    cblkh: int = 6
    cblksty: int = 0
    qmfbid: int = 1
    prcw: List[int] = field(default_factory=lambda: [15] * 33)
    prch: List[int] = field(default_factory=lambda: [15] * 33)
    qntsty: int = 0
    numgbits: int = 2
    stepsizes: List[Tuple[int, int]] = field(default_factory=lambda: [(0, 0)] * 97)   # (expn, mant)
    roishift: int = 0
    dc_shift: int = 0        # OpenJPEG's m_dc_level_shift: from SIZ, or an MCO

    def copy(self) -> "Tccp":
        return Tccp(self.numres, self.cblkw, self.cblkh, self.cblksty, self.qmfbid, list(self.prcw),
                    list(self.prch), self.qntsty, self.numgbits, list(self.stepsizes), self.roishift, self.dc_shift)


@dataclass
class Tcp:
    """A tile's coding parameters (opj_tcp_t)."""
    csty: int = 0
    prg: int = 0
    numlayers: int = 1
    mct: int = 0
    tccps: List[Tccp] = field(default_factory=list)
    pocs: List[Tuple[int, int, int, int, int, int]] = field(default_factory=list)   # resno0, compno0, layno1, resno1, compno1, prg
    ppt: Dict[int, bytes] = field(default_factory=dict)
    data: List[bytes] = field(default_factory=list)
    mct_records: Dict[int, Tuple[int, bytes]] = field(default_factory=dict)   # Part 2 MCT: index -> (element type, data)
    mcc_records: List[list] = field(default_factory=list)   # Part 2 MCC: [index, components, decorrelation, offset]

    def copy(self) -> "Tcp":
        return Tcp(self.csty, self.prg, self.numlayers, self.mct, [t.copy() for t in self.tccps], list(self.pocs),
                   mct_records=dict(self.mct_records), mcc_records=[list(r) for r in self.mcc_records])


@dataclass
class Component:
    dx: int
    dy: int
    prec: int
    sgnd: bool


@dataclass
class Codestream:
    x0: int
    y0: int
    x1: int
    y1: int
    tx0: int
    ty0: int
    tdx: int
    tdy: int
    tw: int
    th: int
    comps: List[Component]
    tcps: List[Tcp]
    tile_order: List[int]                # tiles in the order their data ends
    ppm: Optional[bytes]

    def tile_rect(self, tileno: int) -> Tuple[int, int, int, int]:
        p, q = tileno % self.tw, tileno // self.tw
        return (max(self.tx0 + p * self.tdx, self.x0), max(self.ty0 + q * self.tdy, self.y0),
                min(self.tx0 + (p + 1) * self.tdx, self.x1), min(self.ty0 + (q + 1) * self.tdy, self.y1))


def _read_spcod(seg: bytes, at: int, tccp: Tccp, precincts: bool) -> None:
    tccp.numres = seg[at] + 1
    if tccp.numres > 33:
        raise ValueError("JPEG 2000: too many decomposition levels")
    tccp.cblkw, tccp.cblkh = (seg[at + 1] & 0xF) + 2, (seg[at + 2] & 0xF) + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise ValueError("JPEG 2000: bad code-block size")
    tccp.cblksty = seg[at + 3]
    if tccp.cblksty & HT_MIXED:
        raise ValueError("JPEG 2000: unsupported mixed HT code-block style")
    tccp.qmfbid = seg[at + 4]
    if tccp.qmfbid > 1:
        raise ValueError("JPEG 2000: invalid transformation (an arbitrary wavelet)")
    if precincts:
        for r in range(tccp.numres):
            b = seg[at + 5 + r]
            tccp.prcw[r], tccp.prch[r] = b & 0xF, b >> 4
            if r and (tccp.prcw[r] == 0 or tccp.prch[r] == 0):
                raise ValueError("JPEG 2000: precinct size 1 at a resolution above 0")
    else:
        tccp.prcw[:] = [15] * 33
        tccp.prch[:] = [15] * 33


def _read_sqcd(seg: bytes, at: int, tccp: Tccp) -> None:
    sq = seg[at]
    tccp.qntsty, tccp.numgbits = sq & 0x1F, sq >> 5
    body = seg[at + 1:]
    if tccp.qntsty == 1:
        n = 1
    elif tccp.qntsty == 0:
        n = len(body)
    elif tccp.qntsty == 2:
        n = len(body) // 2
    else:
        raise ValueError("JPEG 2000: bad quantization style")
    n = min(n, 97)
    steps = list(tccp.stepsizes)
    for b in range(n):
        if tccp.qntsty == 0:
            steps[b] = (body[b] >> 3, 0)
        else:
            v = struct.unpack(">H", body[2 * b:2 * b + 2])[0]
            steps[b] = (v >> 11, v & 0x7FF)
    if tccp.qntsty == 1:
        e0, m0 = steps[0]
        for b in range(1, 97):
            steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
    tccp.stepsizes = steps


def _comp_index(seg: bytes, at: int, ncomps: int) -> Tuple[int, int]:
    if ncomps <= 256:
        return seg[at], at + 1
    return struct.unpack(">H", seg[at:at + 2])[0], at + 2


def _apply_marker(marker: int, seg: bytes, tcp: Tcp, ncomps: int, in_tile: bool) -> None:
    """COD, COC, QCD, QCC, RGN, POC, PPT into `tcp` (the default tcp of the
    main header, or a tile's)."""
    if marker == 0xFF52:    # COD
        tcp.csty, tcp.prg = seg[0], seg[1]
        if tcp.prg > 4:
            raise ValueError("JPEG 2000: unknown progression order")
        tcp.numlayers = struct.unpack(">H", seg[2:4])[0]
        if tcp.numlayers == 0:
            raise ValueError("JPEG 2000: zero layers")
        tcp.mct = seg[4]
        if tcp.mct > 1:
            raise ValueError("JPEG 2000: invalid multiple component transformation")
        _read_spcod(seg, 5, tcp.tccps[0], bool(tcp.csty & 1))
        for t in tcp.tccps[1:]:
            src = tcp.tccps[0]
            t.numres, t.cblkw, t.cblkh, t.cblksty, t.qmfbid = src.numres, src.cblkw, src.cblkh, src.cblksty, src.qmfbid
            t.prcw, t.prch = list(src.prcw), list(src.prch)
    elif marker == 0xFF53:  # COC
        c, at = _comp_index(seg, 0, ncomps)
        if c >= ncomps:
            raise ValueError("JPEG 2000: COC of a missing component")
        _read_spcod(seg, at + 1, tcp.tccps[c], bool(seg[at] & 1))
    elif marker == 0xFF5C:  # QCD
        _read_sqcd(seg, 0, tcp.tccps[0])
        for t in tcp.tccps[1:]:
            src = tcp.tccps[0]
            t.qntsty, t.numgbits, t.stepsizes = src.qntsty, src.numgbits, list(src.stepsizes)
    elif marker == 0xFF5D:  # QCC
        c, at = _comp_index(seg, 0, ncomps)
        if c >= ncomps:
            raise ValueError("JPEG 2000: QCC of a missing component")
        _read_sqcd(seg, at, tcp.tccps[c])
    elif marker == 0xFF5E:  # RGN
        c, at = _comp_index(seg, 0, ncomps)
        if c >= ncomps:
            raise ValueError("JPEG 2000: RGN of a missing component")
        tcp.tccps[c].roishift = seg[at + 1]
    elif marker == 0xFF5F:  # POC
        room = 2 if ncomps > 256 else 1
        size = 5 + 2 * room
        for k in range(len(seg) // size):
            r = seg[k * size:(k + 1) * size]
            resno0 = r[0]
            compno0 = int.from_bytes(r[1:1 + room], "big")
            layno1 = min(struct.unpack(">H", r[1 + room:3 + room])[0], tcp.numlayers)
            resno1 = r[3 + room]
            compno1 = min(int.from_bytes(r[4 + room:4 + 2 * room], "big"), ncomps)
            prg = r[4 + 2 * room]
            tcp.pocs.append((resno0, compno0, layno1, resno1, compno1, prg))
    elif marker == 0xFF61 and in_tile:   # PPT
        tcp.ppt[seg[0]] = seg[1:]
    elif marker == 0xFF74:  # MCT
        _read_mct(seg, tcp)
    elif marker == 0xFF75:  # MCC
        _read_mcc(seg, tcp)
    elif marker == 0xFF77:  # MCO
        _read_mco(seg, tcp, ncomps)


_MCT_SIZE = (2, 4, 4, 8)   # int16, int32, float32, float64


def _read_mct(seg: bytes, tcp: Tcp) -> None:
    """`opj_j2k_read_mct`: one array, kept by its index (Zmct or Ymct not 0:
    left unread)."""
    if len(seg) < 2:
        raise ValueError("JPEG 2000: error reading MCT marker")
    if struct.unpack(">H", seg[:2])[0]:
        return
    if len(seg) <= 6:
        raise ValueError("JPEG 2000: error reading MCT marker")
    imct, ymct = struct.unpack(">HH", seg[2:6])
    tcp.mct_records[imct & 0xFF] = ((imct >> 10) & 3, b"" if ymct else seg[6:])


def _read_mcc(seg: bytes, tcp: Tcp) -> None:
    """`opj_j2k_read_mcc`: one collection of array-based decorrelation
    over components 0 .. n - 1 in order; anything else leaves it unread."""
    if len(seg) < 2:
        raise ValueError("JPEG 2000: error reading MCC marker")
    if struct.unpack(">H", seg[:2])[0]:
        return
    if len(seg) < 7:
        raise ValueError("JPEG 2000: error reading MCC marker")
    index = seg[2]
    ymcc, ncoll = struct.unpack(">HH", seg[3:7])
    record = next((r for r in tcp.mcc_records if r[0] == index), None)
    fresh = record is None
    if fresh:
        record = [index, 0, None, None]
    if ymcc or ncoll > 1:
        if not fresh:
            record[0] = index
        return
    left, at = len(seg) - 7, 7
    for _ in range(ncoll):
        if left < 3:
            raise ValueError("JPEG 2000: error reading MCC marker")
        if seg[at] != 1:
            return
        nb = struct.unpack(">H", seg[at + 1:at + 3])[0]
        left -= 3
        at += 3
        width, record[1] = 1 + (nb >> 15), nb & 0x7FFF
        if left < width * record[1] + 2:
            raise ValueError("JPEG 2000: error reading MCC marker")
        left -= width * record[1] + 2
        for j in range(record[1]):
            if int.from_bytes(seg[at:at + width], "big") != j:
                return
            at += width
        nb = struct.unpack(">H", seg[at:at + 2])[0]
        at += 2
        width = 1 + (nb >> 15)
        if nb & 0x7FFF != record[1]:
            return
        if left < width * record[1] + 3:
            raise ValueError("JPEG 2000: error reading MCC marker")
        left -= width * record[1] + 3
        for j in range(record[1]):
            if int.from_bytes(seg[at:at + width], "big") != j:
                return
            at += width
        tmcc = int.from_bytes(seg[at:at + 3], "big")
        at += 3
        record[2] = record[3] = None
        for slot, idx in ((2, tmcc & 0xFF), (3, (tmcc >> 8) & 0xFF)):
            if idx:
                if idx not in tcp.mct_records:
                    raise ValueError("JPEG 2000: error reading MCC marker")
                record[slot] = idx
    if left:
        raise ValueError("JPEG 2000: error reading MCC marker")
    if fresh:
        tcp.mcc_records.append(record)


def _read_mco(seg: bytes, tcp: Tcp, ncomps: int) -> None:
    """`opj_j2k_read_mco` and `opj_j2k_add_mct`: one stage; every DC shift
    to 0, then the stage's offsets where OpenJPEG finds its record (its
    search looks at the first MCC record only)."""
    if len(seg) < 1:
        raise ValueError("JPEG 2000: error reading MCO marker")
    if seg[0] > 1:
        return
    if len(seg) != seg[0] + 1:
        raise ValueError("JPEG 2000: error reading MCO marker")
    for tccp in tcp.tccps:
        tccp.dc_shift = 0
    for stage in seg[1:]:
        if not tcp.mcc_records or tcp.mcc_records[0][0] != stage or tcp.mcc_records[0][1] != ncomps:
            continue
        _, _, deco, offset = tcp.mcc_records[0]
        if deco is not None:
            et, arr = tcp.mct_records[deco]
            if len(arr) != _MCT_SIZE[et] * ncomps * ncomps:
                raise ValueError("JPEG 2000: an MCT decorrelation array of the wrong size")
        if offset is not None:
            et, arr = tcp.mct_records[offset]
            if len(arr) != _MCT_SIZE[et] * ncomps:
                raise ValueError("JPEG 2000: an MCT offset array of the wrong size")
            fmt = (">H", ">i", ">f", ">d")[et]
            for c, (v,) in enumerate(struct.iter_unpack(fmt, arr)):
                tcp.tccps[c].dc_shift = int(v) if abs(v) < 2 ** 31 else -(2 ** 31)   # C's (OPJ_INT32) cast


def _read_cbd(seg: bytes, comps: List["Component"]) -> None:
    """`opj_j2k_read_cbd`: every component's precision and signedness."""
    if len(seg) < 2 or len(seg) - 2 != len(comps) or struct.unpack(">H", seg[:2])[0] != len(comps):
        raise ValueError("JPEG 2000: error reading CBD marker")
    for comp, b in zip(comps, seg[2:]):
        comp.sgnd, comp.prec = bool(b & 0x80), (b & 0x7F) + 1
        if comp.prec > 31:
            raise ValueError("JPEG 2000: CBD precision above 31 bits")


_SKIPPED = {0xFF50, 0xFF55, 0xFF57, 0xFF58, 0xFF59, 0xFF63, 0xFF64}   # CAP, TLM, PLM, PLT, CPF, CRG, COM
# what OpenJPEG reads in a tile-part header (COD, COC, RGN, QCD, QCC, POC, PLT, PPT, COM, MCT,
# MCC, MCO), and the markers it fails in the main header (PLT, PPT)
_TILE_HEADER = {0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF58, 0xFF61, 0xFF64, 0xFF74, 0xFF75, 0xFF77}
_TILE_ONLY = {0xFF58, 0xFF61}


def parse(data: bytes, need_eoc: bool = False) -> Codestream:
    """The codestream `data` (from SOC) into a `Codestream`; `need_eoc`: a
    codestream cut before its EOC is an error, as OpenJPEG's decode of it
    through Pillow is."""
    if data[:4] != J2K_SIGNATURE:
        raise ValueError("JPEG 2000 codestream without SOC / SIZ")
    lsiz = struct.unpack(">H", data[4:6])[0]
    siz = data[4:4 + lsiz]
    if len(siz) < lsiz or lsiz < 41:
        raise ValueError("JPEG 2000: SIZ truncated")
    _, rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    if csiz == 0 or lsiz != 38 + 3 * csiz:
        raise ValueError("JPEG 2000: bad SIZ")
    if not (x0 < x1 and y0 < y1 and tdx and tdy and tx0 <= x0 and ty0 <= y0
            and tx0 + tdx > x0 and ty0 + tdy > y0):
        raise ValueError("JPEG 2000: bad image or tile geometry")
    comps = []
    for c in range(csiz):
        ssiz, dx, dy = siz[38 + 3 * c:41 + 3 * c]
        prec = (ssiz & 0x7F) + 1
        if prec > 38 or not dx or not dy:
            raise ValueError("JPEG 2000: bad component")
        comps.append(Component(dx, dy, prec, bool(ssiz & 0x80)))
    tw = -(-(x1 - tx0) // tdx)
    th = -(-(y1 - ty0) // tdy)
    default = Tcp(tccps=[Tccp(dc_shift=0 if comp.sgnd else 1 << (comp.prec - 1)) for comp in comps])
    pos = 4 + lsiz
    ppm: Dict[int, bytes] = {}
    # main header
    while True:
        if pos + 2 > len(data):
            raise ValueError("JPEG 2000: codestream ends in its main header")
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == 0xFF90:
            break
        if marker < 0xFF30:
            raise ValueError(f"JPEG 2000: bad marker {marker:#06x} in the main header")
        ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + ln]
        if len(seg) < ln - 2 or ln < 2:
            raise ValueError("JPEG 2000: marker segment truncated")
        if marker in _TILE_ONLY:
            raise ValueError(f"JPEG 2000: marker {marker:#06x} is not compliant with its position")
        if marker == 0xFF60:     # PPM
            ppm[seg[0]] = seg[1:]
        elif marker == 0xFF78:   # CBD
            _read_cbd(seg, comps)
        elif marker not in _SKIPPED:
            _apply_marker(marker, seg, default, csiz, False)
        pos += 2 + ln
    tcps = [default.copy() for _ in range(tw * th)]
    started = [False] * (tw * th)
    order: List[int] = []
    # tile-parts
    eoc = False
    while pos + 2 <= len(data):
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == 0xFFD9:
            eoc = True
            break
        if marker != 0xFF90:
            raise ValueError(f"JPEG 2000: expected SOT, found {marker:#06x}")
        if pos + 12 > len(data):
            raise ValueError("JPEG 2000: SOT truncated")
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", data[pos + 4:pos + 12])
        if isot >= tw * th:
            raise ValueError("JPEG 2000: tile index out of range")
        end = pos + psot if psot else len(data) - 2
        if end > len(data):
            raise ValueError("JPEG 2000: tile-part runs past the end of the codestream")
        tcp = tcps[isot]
        at = pos + 12
        while True:
            if at + 2 > end:
                raise ValueError("JPEG 2000: tile-part without SOD")
            marker = struct.unpack(">H", data[at:at + 2])[0]
            if marker == 0xFF93:
                at += 2
                break
            ln = struct.unpack(">H", data[at + 2:at + 4])[0]
            seg = data[at + 4:at + 2 + ln]
            if marker not in _TILE_HEADER:   # a main-header marker, or one OpenJPEG does not know
                raise ValueError(f"JPEG 2000: marker {marker:#06x} in a tile-part header")
            if marker not in _SKIPPED:
                _apply_marker(marker, seg, tcp, csiz, True)
            at += 2 + ln
        tcp.data.append(data[at:end])
        if not started[isot]:
            started[isot] = True
            order.append(isot)
        pos = end
    if not any(started):
        raise ValueError("JPEG 2000: no tile data")
    if need_eoc and not eoc:   # OpenJPEG reads a marker after the last tile-part
        raise ValueError("JPEG 2000: codestream too short (no EOC)")
    ppm_bytes = None
    if ppm:
        joined = b"".join(ppm[z] for z in sorted(ppm))
        parts, at = [], 0
        while at + 4 <= len(joined):
            n = struct.unpack(">I", joined[at:at + 4])[0]
            parts.append(joined[at + 4:at + 4 + n])
            at += 4 + n
        ppm_bytes = b"".join(parts)
    return Codestream(x0, y0, x1, y1, tx0, ty0, tdx, tdy, tw, th, comps, tcps, order, ppm_bytes)


def codestream_of(data: bytes) -> Tuple[bytes, Optional[Jp2Header]]:
    """The codestream of a raw J2K or a JP2 file, and the JP2 header."""
    if data[:4] == J2K_SIGNATURE:
        return data, None
    h = _jp2_header(data)
    if h.codestream is None:
        raise ValueError("JP2 file without a codestream box")
    return data[h.codestream[0]:h.codestream[1]], h


def _open_comment(data: bytes) -> bytes:
    """`Jpeg2KImageFile._parse_comment` as `_open` reaches it: the first
    COM segment of the main header (its text, Rcom dropped), a JP2's only
    when its jp2c box follows jp2h with a short header; b"" without one.
    Raises struct.error or IndexError where Pillow's reads come up short
    (`Image.open` then moves on: no plugin identifies the file)."""
    if data[:4] == J2K_SIGNATURE:
        pos = 4
    else:
        jp2h_end = next(e for t, s, e in _boxes(data, 12, len(data), clip=True) if t == b"jp2h")
        if not data[jp2h_end:jp2h_end + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
            return b""
        pos = jp2h_end + 12
    pos += struct.unpack(">H", data[pos:pos + 2])[0]   # past SIZ
    while True:
        marker = data[pos:pos + 2]
        if not marker:
            return b""
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return b""
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if typ == 0x64:
            return (data[pos + 4:] if length < 2 else data[pos + 4:pos + 2 + length])[2:]
        pos += 2 + length


def pillow_comment(data: bytes) -> bytes:
    """`Image.open(...).info["comment"]` of a JPEG 2000 file (b"" where it
    has none or `Image.open` fails)."""
    try:
        return _open_comment(data)
    except (ValueError, struct.error, IndexError, StopIteration):
        return b""
