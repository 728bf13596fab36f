"""JPEG 2000 page images (JP2, JPH and raw codestreams: Part 1, HTJ2K
(Part 15) and what OpenJPEG 2.5.4 reads of Part 2), decoded as Pillow
12.1 holds them after `Image.open(...).load()` (its `Jpeg2KImagePlugin`
over OpenJPEG 2.5.4's tile API).

Stages:

- headers and tier-2 on the host (`jp2_codestream.py`, `jp2_tier2.py`);
- tier-1 of every Part-1 code block of the image in one call
  (`jpeg2000_t1.py::j2k_t1_decode`: K5 on a CUDA device, the plain
  version on the CPU), then every HT code block (a component whose
  code-block style has 0x40) in one more into the same buffer
  (`jpeg2000_ht.py::j2k_ht_decode`: K6, or the plain version), each
  launched only where the image has such blocks; both write OpenJPEG's
  t1 values, so what follows takes either;
- reconstruction in plain PyTorch on the same device, as OpenJPEG does
  it: dequantization (reversible: the t1 value / 2, truncated; 9/7: the
  float32 value times `0.5f * stepsize`, the step of QCD / QCC with
  `Rb = prec`, as OpenJPEG compensates its `two_invK`), the inverse DWT
  of each level, rows first (5/3 in int32 lifting with symmetric
  extension, a single odd-placed sample halved; 9/7 in float32, each
  lifting step `x + (l + r) * c` in separate ops so nothing fuses into
  an FMA), the RCT / ICT on the first three components when COD asks for
  it (Part 2's custom matrices need COD `mct` 2, which OpenJPEG fails),
  the DC level shift (its component's, from SIZ or an MCO's offsets;
  9/7: `lrintf`, half to even) and the clamp to the component's range
  (CBD's precision and signedness where the codestream has one);
- Pillow's unpacking (`Jpeg2KDecode.c`): the tile data as
  `opj_decode_tile_data` writes it (each component at its own size, in
  1, 2 or 4 bytes a sample), read back with Pillow's strides (the tile's
  width divided by the subsampling, rounded down), each sample shifted to
  8 bits (16 for I;16) with its rounding offset and the signed offset,
  and stored truncated to the mode's width. Pillow reads the raw
  codestream components: a JP2's `pclr` and `cdef` are not applied (P /
  PA keep the indices); its `colr` only picks the unpacker. Three
  components of a `colr` sYCC file go through `ImagingConvertYCbCr2RGB`.

`read_jpeg2000(data, device)` -> (pixels, mode, palette) in
`read_image`'s contract (numpy on the host).
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.utils import jp2_codestream as jcs
from morphik_core_tpu_torch.utils.jp2_tier2 import TileComp, ppm_source, tile_codeblocks
from morphik_core_tpu_torch.utils.jpeg2000_ht import j2k_ht_decode, pack_ht_blocks
from morphik_core_tpu_torch.utils.jpeg2000_t1 import j2k_t1_decode, pack_blocks

# OpenJPEG's float constants (dwt.c, mct.c)
_K = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)
_ALPHA = np.float32(1.586134342)
_BETA = np.float32(0.052980118)
_GAMMA = np.float32(-0.882911075)
_DELTA = np.float32(-0.443506852)
_ICT = (np.float32(1.402), np.float32(0.34413), np.float32(0.71414), np.float32(1.772))


def probe_jpeg2000(data: bytes) -> Tuple[int, int]:
    """(width, height) from the headers, as `Image.open` finds them: every
    codestream `Image.open` opens is decoded, and one OpenJPEG fails fails
    the decode (ValueError), not the probe."""
    return jcs.open_header(data)[1]


# ------------------------------------------------------------------- layout


def _band_origin(tc: TileComp, r: int, bandno: int) -> Tuple[int, int]:
    """Where a sub-band's (0, 0) sits in its tile-component buffer."""
    x = y = 0
    if r:
        prev = tc.resolutions[r - 1]
        if bandno & 1:
            x = prev.x1 - prev.x0
        if bandno & 2:
            y = prev.y1 - prev.y0
    return x, y


def _collect(cs: jcs.Codestream, origins: Optional[list] = None):
    """Tier-2 of every tile -> (per tile: its TileComps and each
    component's buffer offset), the Part-1 code blocks for one K5 launch
    and the HT ones for one K6 launch (by their component's code-block
    style), the buffer's size. `origins`, where given, gets each block's
    kind and corner on its tile-component's grid."""
    blocks, ht_blocks = [], []
    tiles = []
    base = 0
    ppm = ppm_source(cs)
    for t in cs.tile_order:
        tcs = tile_codeblocks(cs, t, ppm)
        tcp = cs.tcps[t]
        offs = []
        for c, tc in enumerate(tcs):
            tw, th = tc.x1 - tc.x0, tc.y1 - tc.y0
            offs.append(base)
            tccp = tcp.tccps[c]
            ht = bool(tccp.cblksty & jcs.HT)
            for r, res in enumerate(tc.resolutions):
                for band in res.bands:
                    ox, oy = _band_origin(tc, r, band.bandno)
                    for prc in band.precincts:
                        if ht and tccp.roishift and prc.blocks:   # OpenJPEG fails every HT block under an ROI shift
                            raise ValueError("JPEG 2000: an ROI shift in an HT code block (OpenJPEG does not decode it)")
                        for cb in prc.blocks:
                            w, h = cb.x1 - cb.x0, cb.y1 - cb.y0
                            if w <= 0 or h <= 0 or not cb.chunks:
                                continue
                            segs = [(s[0], s[1]) for s in cb.segs]   # (bytes, passes); each has a pass
                            out_off = base + (cb.y0 - band.y0 + oy) * tw + (cb.x0 - band.x0 + ox)
                            if ht:
                                ht_blocks.append((cb.chunks, segs, w, h, cb.numbps, band.numbps, tccp.roishift,
                                                  tccp.cblksty, out_off, tw))
                            else:
                                blocks.append((cb.chunks, segs, w, h, band.bandno, cb.numbps, tccp.roishift,
                                               tccp.cblksty, out_off, tw))
                            if origins is not None:   # the block's corner on the component's grid
                                shift = len(tc.resolutions) - (1 if r == 0 else r)
                                origins.append((ht, (cb.x0 - band.x0) << shift, (cb.y0 - band.y0) << shift))
            base += tw * th
        tiles.append((t, tcs, offs))
    return tiles, blocks, ht_blocks, base


# ------------------------------------------------------------ the wavelets


def _interleave(x: torch.Tensor, sn: int, cas: int) -> torch.Tensor:
    """[low (sn) | high] along the last axis -> samples in place order."""
    y = torch.empty_like(x)
    y[..., cas::2] = x[..., :sn]
    y[..., 1 - cas::2] = x[..., sn:]
    return y


def _mirror(y: torch.Tensor) -> torch.Tensor:
    """y with one sample of symmetric extension at each end."""
    n = y.shape[-1]
    return torch.cat([y[..., 1:2], y, y[..., n - 2:n - 1]], dim=-1)


def _idwt53_1d(x: torch.Tensor, sn: int, cas: int) -> torch.Tensor:
    n = x.shape[-1]
    if n == 1:
        return torch.div(x, 2, rounding_mode="trunc") if cas else x
    y = _interleave(x, sn, cas)
    p = _mirror(y)
    lo = y[..., cas::2] - torch.div(p[..., cas:n:2] + p[..., cas + 2:n + 2:2] + 2, 4, rounding_mode="floor")
    y = y.clone()
    y[..., cas::2] = lo
    p = _mirror(y)
    hi = y[..., 1 - cas::2] + torch.div(p[..., 1 - cas:n:2] + p[..., 3 - cas:n + 2:2], 2, rounding_mode="floor")
    y[..., 1 - cas::2] = hi
    return y


def _lift97(y: torch.Tensor, first: int, c: torch.Tensor) -> torch.Tensor:
    """x[t] = x[t] + (x[t - 1] + x[t + 1]) * c at t = first, first + 2, ..."""
    n = y.shape[-1]
    p = _mirror(y)
    s = p[..., first:n:2] + p[..., first + 2:n + 2:2]
    s = s * c
    y = y.clone()
    y[..., first::2] = y[..., first::2] + s
    return y


def _idwt97_1d(x: torch.Tensor, sn: int, cas: int) -> torch.Tensor:
    n = x.shape[-1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return x
    y = _interleave(x, sn, cas)
    y[..., cas::2] = y[..., cas::2] * _f32(_K, x.device)
    y[..., 1 - cas::2] = y[..., 1 - cas::2] * _f32(_TWO_INVK, x.device)
    y = _lift97(y, cas, _f32(_DELTA, x.device))
    y = _lift97(y, 1 - cas, _f32(_GAMMA, x.device))
    y = _lift97(y, cas, _f32(_BETA, x.device))
    y = _lift97(y, 1 - cas, _f32(_ALPHA, x.device))
    return y


def _f32(v: np.float32, device) -> torch.Tensor:
    """A float32 scalar on `device`: a Python float would take the op's
    arithmetic through a double on some backends."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _idwt(buf: torch.Tensor, tc: TileComp, reversible: bool) -> torch.Tensor:
    """`opj_dwt_decode_tile` / `_97`: each level, rows then columns, on the
    (h, w) tile-component buffer."""
    one_d = _idwt53_1d if reversible else _idwt97_1d
    res = tc.resolutions
    for r in range(1, len(res)):
        lo, cur = res[r - 1], res[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        if rw == 0 or rh == 0:
            continue
        sub = buf[:rh, :rw]
        sub = one_d(sub, lo.x1 - lo.x0, cur.x0 % 2)
        sub = one_d(sub.transpose(0, 1), lo.y1 - lo.y0, cur.y0 % 2).transpose(0, 1)
        buf = buf.clone()
        buf[:rh, :rw] = sub
    return buf


# --------------------------------------------------------- reconstruction


def _dequantize(coef: torch.Tensor, cs: jcs.Codestream, tileno: int, c: int, tc: TileComp) -> torch.Tensor:
    tccp = cs.tcps[tileno].tccps[c]
    if tccp.qmfbid == 1:
        return torch.div(coef, 2, rounding_mode="trunc")
    out = coef.to(torch.float32)
    prec = cs.comps[c].prec
    for r, res in enumerate(tc.resolutions):
        for band in res.bands:
            if band.empty():
                continue
            expn, mant = band.stepsize
            step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))
            step = np.float32(np.float32(0.5) * step)
            ox, oy = _band_origin(tc, r, band.bandno)
            h, w = band.y1 - band.y0, band.x1 - band.x0
            out[oy:oy + h, ox:ox + w] = out[oy:oy + h, ox:ox + w] * _f32(step, out.device)
    return out


def _tile_planes(cs: jcs.Codestream, tileno: int, tcs: List[TileComp], coef: torch.Tensor,
                 offs: List[int]) -> List[torch.Tensor]:
    """One tile's components after the IDWT, the MCT and the DC shift:
    int32 (h, w) at each component's size."""
    tcp = cs.tcps[tileno]
    planes = []
    for c, tc in enumerate(tcs):
        w, h = tc.x1 - tc.x0, tc.y1 - tc.y0
        buf = coef[offs[c]:offs[c] + w * h].reshape(h, w)
        buf = _dequantize(buf, cs, tileno, c, tc)
        if w and h:
            buf = _idwt(buf, tc, tcp.tccps[c].qmfbid == 1)
        planes.append(buf)
    if tcp.mct and len(planes) >= 3:
        if any(p.shape != planes[0].shape for p in planes[1:3]):
            raise ValueError("JPEG 2000: tiles don't all have the same dimension; cannot apply the MCT")
        y, u, v = planes[:3]
        if tcp.tccps[0].qmfbid == 1:
            g = y - torch.div(u + v, 4, rounding_mode="floor")
            planes[:3] = [v + g, g, u + g]
        else:
            r_ = y + v * _f32(_ICT[0], y.device)
            g_ = y - u * _f32(_ICT[1], y.device)
            g_ = g_ - v * _f32(_ICT[2], y.device)
            b_ = y + u * _f32(_ICT[3], y.device)
            planes[:3] = [r_, g_, b_]
    out = []
    for c, p in enumerate(planes):
        comp = cs.comps[c]
        lo, hi = (-(1 << (comp.prec - 1)), (1 << (comp.prec - 1)) - 1) if comp.sgnd else (0, (1 << comp.prec) - 1)
        shift = tcp.tccps[c].dc_shift
        if p.dtype == torch.float32:
            p = torch.round(p).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)
        else:
            p = p.to(torch.int64)
        out.append((p + shift).clamp(lo, hi))
    return out


def decode_components(data: bytes, device, stages: Optional[dict] = None):
    """The codestream of `data` -> (its Codestream, per tile (its rect,
    its components as int64 planes on `device`)). `stages`, where given,
    gets the ms of headers + tier-2 (host), tier-1 (K5), the HT blocks
    (K6) and the DWT and component transforms (the device synchronized
    after each), and the blocks and bytes of each kind."""
    t0 = time.perf_counter()
    stream, header = jcs.codestream_of(data)
    try:
        cs = jcs.parse(stream, need_eoc=True)
        tiles, blocks, ht_blocks, n_total = _collect(cs)
    except (struct.error, IndexError) as e:   # a header or packet cut short
        raise ValueError(f"JPEG 2000: broken codestream ({e})") from e
    packed = pack_blocks(blocks)
    ht_packed = pack_ht_blocks(ht_blocks)
    t1 = time.perf_counter()
    coef = j2k_t1_decode(packed, n_total, device)
    t2 = _synced(coef, stages)
    if len(ht_packed):
        coef = j2k_ht_decode(ht_packed, n_total, device, out=coef)
    t3 = _synced(coef, stages)
    out = []
    for t, tcs, offs in tiles:
        out.append((cs.tile_rect(t), _tile_planes(cs, t, tcs, coef, offs)))
    t4 = _synced(coef, stages)
    if stages is not None:
        stages.update(headers_tier2_ms=(t1 - t0) * 1e3, tier1_ms=(t2 - t1) * 1e3, ht_ms=(t3 - t2) * 1e3,
                      idwt_mct_ms=(t4 - t3) * 1e3, code_blocks=len(packed), ht_code_blocks=len(ht_packed),
                      coefficient_bytes=4 * n_total,
                      segment_bytes=packed.nbytes + ht_packed.nbytes)
    return cs, out


def _synced(t: torch.Tensor, stages: Optional[dict]) -> float:
    if stages is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def code_blocks(data: bytes, crop: Optional[int] = None, ht: bool = False):
    """The packed Part-1 code blocks of `data`'s image for one K5 launch
    (with `ht`, its HT ones for one K6 launch) and the size of its
    coefficient buffer: all of them, or those whose corner lies in the
    top-left `crop` x `crop` of their tile-component."""
    stream, _ = jcs.codestream_of(data)
    origins: list = []
    _, blocks, ht_blocks, n_total = _collect(jcs.parse(stream, need_eoc=True), origins)
    corners = [(x, y) for kind, x, y in origins if kind == ht]
    chosen = ht_blocks if ht else blocks
    if crop is not None:
        chosen = [b for b, (x, y) in zip(chosen, corners) if x < crop and y < crop]
    return (pack_ht_blocks if ht else pack_blocks)(chosen), n_total


def component_planes(data: bytes, device=None) -> List[np.ndarray]:
    """Each codestream component as one int32 plane of the whole image
    (what `opj_decode` of the raw codestream holds in `comps[i].data`);
    `device` as `read_jpeg2000`'s."""
    if device is None:
        from morphik_core_tpu_torch.device import default_device
        device = default_device()
    cs, tiles = decode_components(data, device)
    planes = []
    for c, comp in enumerate(cs.comps):
        cx0, cy0 = -(-cs.x0 // comp.dx), -(-cs.y0 // comp.dy)
        cx1, cy1 = -(-cs.x1 // comp.dx), -(-cs.y1 // comp.dy)
        plane = np.zeros((cy1 - cy0, cx1 - cx0), np.int32)
        for (tx0, ty0, tx1, ty1), comps in tiles:
            px0, py0 = -(-tx0 // comp.dx) - cx0, -(-ty0 // comp.dy) - cy0
            p = comps[c].cpu().numpy().astype(np.int32)
            plane[py0:py0 + p.shape[0], px0:px0 + p.shape[1]] = p
        planes.append(plane)
    return planes


# ---------------------------------------------------------- Pillow's unpack

def _csize(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _tile_bytes(planes, comps) -> bytes:
    """A tile as `opj_tcd_update_tile_data` writes it: each component at
    its own size, samples of 1, 2 or 4 bytes (little-endian, cut to their
    width)."""
    parts = []
    for p, comp in zip(planes, comps):
        n = _csize(comp.prec)
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[n]
        parts.append((p.cpu().numpy().astype(np.int64) & ((1 << (8 * n)) - 1)).astype(dt).tobytes())
    return b"".join(parts)


def _words(buf: np.ndarray, off: int, csiz: int, idx: np.ndarray) -> np.ndarray:
    """Unsigned `csiz`-byte little-endian words at byte `off` + csiz * idx."""
    at = off + csiz * idx
    v = np.zeros(idx.shape, np.int64)
    for k in range(csiz):
        v |= buf[at + k].astype(np.int64) << (8 * k)
    return v


def _shift_offset(comp: jcs.Component, bits: int) -> Tuple[int, int]:
    shift = bits - comp.prec
    offset = (1 << (comp.prec - 1)) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    return shift, offset


def _sample(words: np.ndarray, comp: jcs.Component, bits: int) -> np.ndarray:
    """`j2ku_shift(offset + word, shift)` stored in `bits` bits."""
    shift, offset = _shift_offset(comp, bits)
    v = offset + words
    v = v >> -shift if shift < 0 else v << shift
    return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's `ImagingConvertYCbCr2RGB` (ConvertYCbCr.c): r = y +
    (R_Cr[cr] >> 6), g = y + ((G_Cb[cb] + G_Cr[cr]) >> 6), b = y + (B_Cb[cb]
    >> 6), clipped."""
    y = ycc[..., 0].astype(np.int64)
    cb = ycc[..., 1].astype(np.int64)
    cr = ycc[..., 2].astype(np.int64)
    r = y + _R_CR6[cr]
    g = y + ((_G_CB[cb] + _G_CR[cr]) >> 6)
    b = y + _B_CB6[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _tables():
    """ConvertYCbCr.c's tables: round(f * 64 * (i - 128)) for the ITU-R
    601 factors, but for the entries where Pillow's own table differs
    (found against `Image.convert` over every input)."""
    i = np.arange(256) - 128
    r6 = np.round(1.402 * 64 * i).astype(np.int64) >> 6
    r6[[21, 118, 123]] += 1
    b6 = np.round(1.772 * 64 * i).astype(np.int64) >> 6
    b6[[14, 93]] += 1
    gb = np.round(-0.34414 * 64 * i).astype(np.int64)
    gb[[1, 4, 6, 9, 11, 13, 14, 16, 18, 19, 21, 23, 26, 28, 30, 31, 33, 35, 38, 40, 43, 45, 48, 50, 53, 55, 57, 58,
        60, 62, 63, 65, 67, 70, 72, 74, 75, 77, 79, 80, 82, 84, 87, 89, 92, 94, 97, 99, 102, 104, 106, 107, 109, 111,
        114, 116, 118, 119, 121, 123, 124, 126, 128]] -= 1
    gr = np.round(-0.71414 * 64 * i).astype(np.int64) + 1 + (i > 0)
    return r6, b6, gb, gr


_R_CR6, _B_CB6, _G_CB, _G_CR = _tables()


def _unpacker(mode: str, color_space: int, n: int, subsampling: bool) -> Optional[str]:
    """Pillow's `j2k_unpackers` table: the first row of this mode, colour
    space and component count that takes subsampled components if the
    image has them. An unspecified colour space is gray for 1-2
    components, and sRGB for 3-4, or sYCC when components after the first
    are subsampled."""
    if color_space == jcs.CS_UNSPECIFIED:
        if n in (1, 2):
            color_space = jcs.CS_GRAY
        elif n in (3, 4):
            color_space = jcs.CS_SYCC if subsampling else jcs.CS_SRGB
    G, S, Y, K = jcs.CS_GRAY, jcs.CS_SRGB, jcs.CS_SYCC, jcs.CS_CMYK
    table = [("L", G, 1, 0, "gray_l"), ("P", S, 1, 0, "gray_l"), ("PA", S, 2, 0, "graya_la"),
             ("I;16", G, 1, 0, "gray_i"), ("LA", G, 2, 0, "graya_la"), ("RGB", G, 1, 0, "gray_rgb"),
             ("RGB", G, 2, 0, "gray_rgb"), ("RGB", S, 3, 1, "srgb_rgb"), ("RGB", Y, 3, 1, "sycc_rgb"),
             ("RGB", S, 4, 1, "srgb_rgb"), ("RGB", Y, 4, 1, "sycc_rgb"), ("RGBA", G, 1, 0, "gray_rgb"),
             ("RGBA", G, 2, 0, "graya_la"), ("RGBA", S, 3, 1, "srgb_rgb"), ("RGBA", Y, 3, 1, "sycc_rgb"),
             ("RGBA", S, 4, 1, "srgba_rgba"), ("RGBA", Y, 4, 1, "sycca_rgba"), ("RGBA", G, 4, 1, "srgba_rgba"),
             ("CMYK", K, 4, 1, "srgba_rgba")]
    for m, cspace, comps, sub, name in table:
        if m == mode and cspace == color_space and comps == n and (sub or not subsampling):
            return name
    return None


def _color_space(header: Optional[jcs.Jp2Header]) -> int:
    if header is None:
        return jcs.CS_UNSPECIFIED
    return jcs.ENUMCS.get(header.enumcs, jcs.CS_UNSPECIFIED)


def unpack(cs: jcs.Codestream, tiles, mode: str, color_space: int, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `j2k_decode_entry` after each `opj_decode_tile_data`: the
    tile lands in Pillow's buffer (grown, and zeroed, when a tile needs
    more; otherwise holding the last tile's bytes past this one's) and
    the unpacker reads it with its own strides."""
    n = len(cs.comps)
    if n < 1 or n > 4:
        raise OSError("broken data stream when reading image file")
    subsampling = any(c.dx != 1 or c.dy != 1 for c in cs.comps[1:])
    name = _unpacker(mode, color_space, n, subsampling)
    if name is None:
        raise OSError("broken data stream when reading image file")
    W, H = size
    comps = cs.comps
    csiz = [_csize(c.prec) for c in comps]
    img = np.zeros((H, W) if mode in ("L", "P", "I;16") else (H, W, 4), np.uint16 if mode == "I;16" else np.uint8)
    buf = np.zeros(0, np.uint8)
    for (tx0, ty0, tx1, ty1), planes in tiles:
        x0, y0 = tx0 - cs.x0, ty0 - cs.y0
        w, h = tx1 - tx0, ty1 - ty0
        if x0 < 0 or y0 < 0 or x0 + w > W or y0 + h > H:
            raise OSError("broken data stream when reading image file")
        raw = np.frombuffer(_tile_bytes(planes, comps), np.uint8)
        need = max(len(raw), w * h * sum(csiz))
        if len(buf) < need:
            buf = np.zeros(need, np.uint8)
        buf[:len(raw)] = raw
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        flat = ys * w + xs
        out = img[y0:y0 + h, x0:x0 + w]
        if name in ("gray_l", "gray_i"):
            out[...] = _sample(_words(buf, 0, csiz[0], flat), comps[0], 16 if name == "gray_i" else 8)
        elif name == "gray_rgb":
            out[..., :3] = _sample(_words(buf, 0, csiz[0], flat), comps[0], 8)[..., None]
            out[..., 3] = 255
        elif name == "graya_la":
            out[..., :3] = _sample(_words(buf, 0, csiz[0], flat), comps[0], 8)[..., None]
            out[..., 3] = _sample(_words(buf, csiz[0] * w * h, csiz[1], flat), comps[1], 8)
        else:
            k = 4 if name in ("srgba_rgba", "sycca_rgba") else 3
            chans, off = [], 0
            for i in range(k):
                cw, ch = w // comps[i].dx, h // comps[i].dy
                idx = (ys // comps[i].dy) * cw + xs // comps[i].dx
                chans.append(_sample(_words(buf, off, csiz[i], idx), comps[i], 8))
                off += csiz[i] * cw * ch
            px = np.stack(chans, -1)
            if name.startswith("sycc"):
                px = np.concatenate([_ycbcr_to_rgb(px[..., :3]), px[..., 3:]], -1)
            out[..., :k] = px
            if k == 3:
                out[..., 3] = 255
    if mode in ("L", "P", "I;16"):
        return img
    if mode in ("LA", "PA"):
        return np.ascontiguousarray(img[..., [0, 3]])
    if mode == "RGB":
        return np.ascontiguousarray(img[..., :3])
    return img


def read_jpeg2000(data: bytes, device=None, stages: Optional[dict] = None
                  ) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """JP2 / JPH / codestream bytes -> (pixels, mode, palette) as Pillow
    holds them. `device` runs the block decoding and the reconstruction
    (K5 and K6 on a card); unset, the card (`device.default_device()`).
    `stages`: see `decode_components`, and the ms of Pillow's unpacking on
    the host."""
    if device is None:
        from morphik_core_tpu_torch.device import default_device
        device = default_device()
    _, size, mode, palette = jcs.open_header(data)
    _, header = jcs.codestream_of(data)
    cs, tiles = decode_components(data, device, stages)
    t0 = time.perf_counter()
    pixels = unpack(cs, tiles, mode, _color_space(header), size)
    if stages is not None:
        stages["unpack_ms"] = (time.perf_counter() - t0) * 1e3
    return pixels, mode, palette
