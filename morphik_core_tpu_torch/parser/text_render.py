"""The text-render page of `morphik_core_tpu/parser/pdf.py::_render_text_page`
without PIL or FreeType (the card's machine has neither, and may have no
font): extracted text drawn in DejaVuSans on a white letter-sized page.

The glyphs come from a committed atlas, `glyphs_dejavu_sans.npz`, that
`write_glyph_atlas` makes with PIL from DejaVuSans.ttf (on a machine
with PIL and the font; nothing on the serving path runs it). For each
font size the reference draws (18 px at 150 dpi, 12 px at 100 dpi) it
holds every token's mask as PIL draws it alone at an integer origin
(with its offset from the origin), its advance in 1/64 px, the pair
kerning between tokens (`getlength(ab) - getlength(a) - getlength(b)`)
and the ligatures of the font's `liga` feature (a token is a character
or a ligature: "ff", "fi", "fl", "ffi", "ffl").

The reference's layout is Pillow's raqm (HarfBuzz), mirrored here:
ligatures are taken greedily in the font's order; the pen advances in
26.6 fixed point by each token's advance plus the kerning with the next
token; a glyph sits at `(pen + 32) >> 6`; overlapping glyphs of a line
composite as `src + dst * (255 - src) / 255` (`_imagingft.c`), and each
line's mask is blended black over the page (`draw_bitmap`). The page
layout (margin, line height, `max_chars` wrapping, the half line after
an empty line, "(no extractable text)") is `_render_text_page`'s.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ATLAS_PATH = Path(__file__).with_name("glyphs_dejavu_sans.npz")
ATLAS_DPIS = (150, 100)
FONT_NAME = "DejaVuSans.ttf"
# Latin-1 (controls included: PDF strings carry them), Latin Extended-A,
# General Punctuation without its direction marks, embeddings and
# isolates (raqm runs the bidi algorithm over those), Currency Symbols,
# U+2122 and U+FFFD
CHARSET = "".join(chr(c) for c in [*range(0x00, 0x0A), *range(0x0B, 0x180), *range(0x2000, 0x200E),
                                   *range(0x2010, 0x202A), *range(0x202F, 0x2066), *range(0x206A, 0x2070),
                                   *range(0x20A0, 0x20C1), 0x2122, 0xFFFD])
ZWNJ = "\u200c"


def font_size(dpi: int) -> int:
    return max(10, dpi // 8)


class GlyphFont:
    """One font size of the atlas."""

    def __init__(self, tokens: List[str], masks: List[np.ndarray], offsets: np.ndarray, advances: np.ndarray,
                 kern: Dict[Tuple[int, int], int], ligatures: List[str], hidden: np.ndarray):
        self.index = {t: i for i, t in enumerate(tokens)}
        self.masks = masks
        self.offsets = offsets.tolist()
        self.advances = advances.tolist()
        self.kern = kern
        self.ligatures = ligatures
        # default-ignorable tokens (soft hyphen, zero-width and invisible
        # format characters): HarfBuzz hides them, and kerning reaches across
        self.hidden = set(hidden.tolist())

    def _ligature_at(self, line: str, i: int) -> Tuple[str, List[str]]:
        """The first ligature (font order) starting at `line[i]`, matched
        across hidden characters but a ZWNJ (which breaks a ligature) as
        HarfBuzz's skippy iterator does, and
        the hidden characters it skipped (they follow the ligature) -> (the
        ligature or line[i], skipped); the match spans len(ligature) +
        len(skipped) characters."""
        for lig in self.ligatures:
            j, skipped = i, []
            for k, ch in enumerate(lig):
                while k and j < len(line) and line[j] not in (ch, ZWNJ) and self.index.get(line[j]) in self.hidden:
                    skipped.append(line[j])
                    j += 1
                if j >= len(line) or line[j] != ch:
                    break
                j += 1
            else:
                return lig, skipped
        return line[i], []

    def tokens(self, line: str) -> List[int]:
        """Characters -> token ids, ligatures taken greedily in font order."""
        out, i = [], 0
        while i < len(line):
            tok, skipped = self._ligature_at(line, i)
            for t in [tok] + skipped:
                if t not in self.index:
                    raise ValueError(
                        f"character {t!r} (U+{ord(t[0]):04X}) is not in the glyph atlas {ATLAS_PATH.name} "
                        "(Latin-1, Latin Extended-A, General Punctuation but its bidi controls, Currency "
                        "Symbols): extend CHARSET and regenerate it with text_render.write_glyph_atlas() "
                        "(needs PIL; ROADMAP Queue 1 item 3b-ii)")
                out.append(self.index[t])
            i += len(tok) + len(skipped)
        return out

    def line_mask(self, line: str) -> Tuple[np.ndarray, int, int]:
        """-> (mask, x offset, y offset) of a line drawn at origin (0, 0)
        with anchor "la", as `FreeTypeFont.getmask2` gives it."""
        ids = self.tokens(line)
        places = []
        pen = 0
        nxt = len(ids)
        after = [0] * len(ids)   # the next visible token after each position
        for k in range(len(ids) - 1, -1, -1):
            after[k] = nxt
            if ids[k] not in self.hidden:
                nxt = k
        for k, t in enumerate(ids):
            ox, oy = self.offsets[t]
            m = self.masks[t]
            if m.size:
                places.append((((pen + 32) >> 6) + ox, oy, m))
            pen += self.advances[t]
            if t not in self.hidden and after[k] < len(ids):
                pen += self.kern.get((t, ids[after[k]]), 0)
        if not places:
            return np.zeros((0, 0), np.uint8), 0, 0
        x0 = min(p[0] for p in places)
        y0 = min(p[1] for p in places)
        x1 = max(p[0] + p[2].shape[1] for p in places)
        y1 = max(p[1] + p[2].shape[0] for p in places)
        out = np.zeros((y1 - y0, x1 - x0), np.int64)
        for x, y, m in places:
            reg = out[y - y0:y - y0 + m.shape[0], x - x0:x - x0 + m.shape[1]]
            t = reg * (255 - m) + 128
            reg[...] = m + (((t >> 8) + t) >> 8)
        return out.astype(np.uint8), x0, y0


@functools.lru_cache(maxsize=None)
def load_font(dpi: int) -> GlyphFont:
    """The atlas font for `_render_text_page(..., dpi)`."""
    if dpi not in ATLAS_DPIS:
        raise ValueError(f"the glyph atlas {ATLAS_PATH.name} holds dpi {ATLAS_DPIS}, not {dpi}: add it to "
                         "ATLAS_DPIS and regenerate with text_render.write_glyph_atlas() (needs PIL)")
    size = font_size(dpi)
    with np.load(ATLAS_PATH) as z:
        tokens = [str(t) for t in z[f"tokens_{size}"]]
        shapes = z[f"shapes_{size}"]
        flat = z[f"masks_{size}"]
        starts = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
        masks = [flat[starts[i]:starts[i + 1]].reshape(shapes[i]).astype(np.int64) for i in range(len(tokens))]
        kp = z[f"kern_{size}"]
        kern = {(int(a), int(b)): int(v) for a, b, v in kp}
        return GlyphFont(tokens, masks, z[f"offsets_{size}"], z[f"advances_{size}"], kern,
                         [str(t) for t in z["ligatures"]], z[f"hidden_{size}"])


def _blend_black(page: np.ndarray, mask: np.ndarray, x: int, y: int) -> None:
    """`draw_bitmap(coord, mask, ink=black)` on a gray page (Paste.c
    `fill_mask_L`: BLEND(mask, out, 0) = DIV255(out * (255 - mask))),
    clipped to the page."""
    h, w = page.shape
    ys, xs = max(0, -y), max(0, -x)
    ye, xe = min(mask.shape[0], h - y), min(mask.shape[1], w - x)
    if ye <= ys or xe <= xs:
        return
    m = mask[ys:ye, xs:xe].astype(np.int64)
    reg = page[y + ys:y + ye, x + xs:x + xe]
    t = reg.astype(np.int64) * (255 - m) + 128
    reg[...] = (((t >> 8) + t) >> 8).astype(np.uint8)


def render_text_page(text: str, dpi: int) -> np.ndarray:
    """`_render_text_page(text, dpi)` -> its (H, W, 3) uint8 RGB pixels."""
    font = load_font(dpi)
    w, h = int(8.5 * dpi), int(11 * dpi)
    page = np.full((h, w), 255, np.uint8)
    margin = dpi // 2
    max_chars = max(20, (w - 2 * margin) // max(6, dpi // 14))
    y = margin
    line_h = max(12, dpi // 6)
    for raw_line in (text or "(no extractable text)").split("\n"):
        line = raw_line
        while line and y < h - margin:
            mask, ox, oy = font.line_mask(line[:max_chars])
            if mask.size:
                _blend_black(page, mask, margin + ox, y + oy)
            line = line[max_chars:]
            y += line_h
        if y >= h - margin:
            break
        if not raw_line:
            y += line_h // 2
    return np.repeat(page[..., None], 3, axis=2)


def write_glyph_atlas(path: Path = ATLAS_PATH, charset: str = CHARSET) -> Path:
    """Make the atlas with PIL (and fontTools for the ligature list) from
    the DejaVuSans.ttf that `ImageFont.truetype("DejaVuSans.ttf")` finds:
    the reference's font. It needs PIL; the serving path never calls it."""
    from fontTools.ttLib import TTFont
    from PIL import ImageFont

    probe = ImageFont.truetype(FONT_NAME, size=12)
    ligatures = _font_ligatures(TTFont(probe.path), charset)
    arrays: Dict[str, np.ndarray] = {"ligatures": np.array(ligatures)}
    for dpi in ATLAS_DPIS:
        size = font_size(dpi)
        font = ImageFont.truetype(FONT_NAME, size=size)
        tokens = list(charset) + ligatures
        shapes, offsets, flat = [], [], []
        for t in tokens:
            m, off = font.getmask2(t, "L", anchor="la")
            arr = np.array(m, dtype=np.uint8).reshape(m.size[1], m.size[0])
            shapes.append(arr.shape)
            offsets.append(off)
            flat.append(arr.reshape(-1))
        adv = [round(font.getlength(t) * 64) for t in tokens]
        av = font.getlength("AV")
        hidden = [i for i, t in enumerate(tokens)
                  if adv[i] == 0 and not flat[i].size and font.getlength("A" + t + "V") == av]
        shaper = GlyphFont(tokens, [], np.zeros((0, 2)), np.zeros(0), {}, ligatures, np.array(hidden))
        kern = []
        for a, ta in enumerate(tokens):
            if a in hidden:
                continue
            for b, tb in enumerate(tokens):
                if b in hidden or shaper.tokens(ta + tb) != [a, b]:
                    continue   # a ligature takes the pair: never two tokens
                k = round(font.getlength(ta + tb) * 64) - adv[a] - adv[b]
                if k:
                    kern.append((a, b, k))
        arrays.update({
            f"tokens_{size}": np.array(tokens),
            f"shapes_{size}": np.array(shapes, np.int32).reshape(-1, 2),
            f"offsets_{size}": np.array(offsets, np.int32).reshape(-1, 2),
            f"masks_{size}": np.concatenate(flat),
            f"advances_{size}": np.array(adv, np.int32),
            f"kern_{size}": np.array(kern, np.int32).reshape(-1, 3),
            f"hidden_{size}": np.array(hidden, np.int32),
        })
    np.savez_compressed(path, **arrays)
    load_font.cache_clear()
    return Path(path)


def _font_ligatures(ttf, charset: str) -> List[str]:
    """The `liga` substitutions of the font's Latin default language
    system whose components are all in `charset`, in the order HarfBuzz
    tries them (lookup, then the ligature set's own order)."""
    gsub = ttf["GSUB"].table
    cmap = ttf.getBestCmap()
    char_of = {}
    for cp, name in sorted(cmap.items()):
        char_of.setdefault(name, chr(cp))
    script = next(s for s in gsub.ScriptList.ScriptRecord if s.ScriptTag == "latn")
    lookups = []
    for fi in script.Script.DefaultLangSys.FeatureIndex:
        rec = gsub.FeatureList.FeatureRecord[fi]
        if rec.FeatureTag == "liga":
            lookups.extend(rec.Feature.LookupListIndex)
    out = []
    for li in sorted(lookups):
        for sub in gsub.LookupList.Lookup[li].SubTable:
            for first, ligs in getattr(sub, "ligatures", {}).items():
                for lig in ligs:
                    names = [first] + list(lig.Component)
                    if all(n in char_of and char_of[n] in charset for n in names):
                        out.append("".join(char_of[n] for n in names))
    return out
