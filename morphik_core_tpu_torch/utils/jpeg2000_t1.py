"""JPEG 2000 tier-1 (EBCOT): each code block's coding passes into signed
coefficients, as OpenJPEG 2.5.4's `t1.c` / `mqc.c` decode them; and K5,
its kernel for the card (`csrc/j2k_t1.cu`).

The coefficients are in OpenJPEG's t1 representation: bit plane `b` of
the magnitude at bit `b + 1`, with the half of the next undecoded plane
set (`oneplushalf` on becoming significant, +-`poshalf` on each
refinement, OpenJPEG's mid-point reconstruction), then the ROI
max-shift undone (`opj_t1_clbl_decode_processor`: magnitudes at or
above `1 << roishift` shifted down). Every Part-1 code-block style:
BYPASS (raw significance and refinement passes from the fifth plane on,
decided at each segment's start), RESET, TERMALL, VSC (a stripe's last
row ignores the row below), PTERM (nothing to do when decoding) and
SEGSYM (four UNIFORM decisions after each cleanup pass). A segment reads
0xFF past its end (OpenJPEG's artificial 0xFF 0xFF marker).

`pack_blocks` lays the code blocks of a whole image out for one launch,
heaviest first: one u8 buffer of every block's data, an int32 table of
(length, passes) a segment, and an int32 descriptor a block
(`DESC_FIELDS`). `j2k_t1_decode` runs them: on the CPU with
`decode_block` (plain Python, one block after another), on a CUDA device
with K5 (one launch an image, a warp a block).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.utils.jp2_codestream import LAZY, RESET, SEGSYM, VSC

# the MQ coder's states (ISO 15444-1 Table C.2): Qe, next on MPS, next on LPS, switch
MQ_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
         0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
         0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
         0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
MQ_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
           28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
MQ_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23,
           24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
MQ_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32

CTX_AGG, CTX_UNI = 17, 18
N_CTX = 19

# a coefficient's flag word: its neighbours' significance (W E N S NW NE SW SE),
# the signs of the four direct ones, and its own state
F_W, F_E, F_N, F_S, F_NW, F_NE, F_SW, F_SE = 1, 2, 4, 8, 16, 32, 64, 128
G_W, G_E, G_N, G_S = 256, 512, 1024, 2048
F_SIG, F_PI, F_MU = 4096, 8192, 16384
F_NEIGH = 0xFF


def _zc_lut() -> List[List[int]]:
    """`t1_init_ctxno_zc`: the zero-coding context for each orientation
    (0 LL, 1 HL, 2 LH, 3 HH: the band's number in its resolution) and
    neighbourhood; HL counts its vertical neighbours as horizontal."""
    out = []
    for orient in range(4):
        row = []
        for f in range(256):
            h = bool(f & F_W) + bool(f & F_E)
            v = bool(f & F_N) + bool(f & F_S)
            d = bool(f & F_NW) + bool(f & F_NE) + bool(f & F_SW) + bool(f & F_SE)
            if orient == 1:
                h, v = v, h
            if orient < 3:
                if h == 0:
                    n = (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else (3 if v == 1 else 4)
                elif h == 1:
                    n = (5 if d == 0 else 6) if v == 0 else 7
                else:
                    n = 8
            else:
                hv = h + v
                if d == 0:
                    n = 0 if hv == 0 else 1 if hv == 1 else 2
                elif d == 1:
                    n = 3 if hv == 0 else 4 if hv == 1 else 5
                elif d == 2:
                    n = 6 if hv == 0 else 7
                else:
                    n = 8
            row.append(n)
        out.append(row)
    return out


def _sc_lut() -> List[Tuple[int, int]]:
    """`t1_init_ctxno_sc` / `t1_init_spb`, indexed by the four direct
    neighbours' significance (bits 0-3) and signs (bits 4-7)."""
    out = []
    for f in range(256):
        def contrib(sig_bit, neg_bit):
            return 0 if not f & sig_bit else (-1 if f & neg_bit else 1)
        hc = max(-1, min(1, contrib(1, 16) + contrib(2, 32)))
        vc = max(-1, min(1, contrib(4, 64) + contrib(8, 128)))
        spb = 0 if (hc == 0 and vc == 0) else int(not (hc > 0 or (hc == 0 and vc > 0)))
        if hc < 0:
            hc, vc = -hc, -vc
        n = (1 if vc else 0) if hc == 0 else (2 if vc == -1 else 3 if vc == 0 else 4)
        out.append((9 + n, spb))
    return out


ZC_LUT = _zc_lut()
SC_LUT = _sc_lut()


def _sc_index(f: int) -> int:
    return (f & 15) | ((f >> 4) & 0xF0)


def decode_block(buf: bytes, start: int, segs: Sequence[Tuple[int, int]], w: int, h: int, orient: int,
                 numbps: int, roishift: int, cblksty: int, counts: Optional[dict] = None) -> List[int]:
    """One code block (`opj_t1_decode_cblk`, then the ROI shift of
    `opj_t1_clbl_decode_processor`) -> its w * h coefficients, row-major.
    `counts`, where given, gets the block's MQ and raw decisions added
    under "decisions" (the length of its serial chain)."""
    data = [0] * (w * h)
    if not segs or w <= 0 or h <= 0:
        return data
    bpno_plus_one = roishift + numbps
    if bpno_plus_one >= 31:
        raise ValueError(f"JPEG 2000: unsupported bpno_plus_one = {bpno_plus_one} >= 31")
    W2 = w + 2
    flags = [0] * (W2 * (h + 2))
    zc = ZC_LUT[orient]
    vsc = bool(cblksty & VSC)
    # scan order: stripes of four rows, column by column
    stripes = []
    for k in range(0, h, 4):
        cols = []
        rows = min(4, h - k)
        for i in range(w):
            cols.append([((k + j + 1) * W2 + i + 1, (k + j) * w + i, j) for j in range(rows)])
        stripes.append((rows == 4, cols))

    st = [0] * N_CTX
    mps = [0] * N_CTX

    def reset_ctx():
        for k in range(N_CTX):
            st[k] = 0
            mps[k] = 0
        st[CTX_UNI] = 46
        st[CTX_AGG] = 3
        st[0] = 4

    reset_ctx()
    # decoder registers: [a, c, ct, bp, end]
    reg = [0, 0, 0, 0, 0]

    def byte(i):
        return buf[i] if i < reg[4] else 0xFF

    def bytein():
        bp = reg[3]
        nxt = byte(bp + 1)
        if byte(bp) == 0xFF:
            if nxt > 0x8F:
                reg[1] += 0xFF00
                reg[2] = 8
            else:
                reg[3] = bp + 1
                reg[1] += nxt << 9
                reg[2] = 7
        else:
            reg[3] = bp + 1
            reg[1] += nxt << 8
            reg[2] = 8

    def init_mq(bp, end):
        reg[3], reg[4] = bp, end
        reg[1] = byte(bp) << 16
        bytein()
        reg[1] = (reg[1] << 7) & 0xFFFFFFFF
        reg[2] -= 7
        reg[0] = 0x8000

    def init_raw(bp, end):
        reg[3], reg[4] = bp, end
        reg[1] = 0
        reg[2] = 0

    def decode(cx):
        s = st[cx]
        qe = MQ_QE[s]
        a = reg[0] - qe
        c = reg[1]
        if (c >> 16) < qe:
            if a < qe:
                d = mps[cx]
                st[cx] = MQ_NMPS[s]
            else:
                d = 1 - mps[cx]
                if MQ_SWITCH[s]:
                    mps[cx] = d
                st[cx] = MQ_NLPS[s]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                reg[0], reg[1] = a, c
                return mps[cx]
            if a < qe:
                d = 1 - mps[cx]
                if MQ_SWITCH[s]:
                    mps[cx] = d
                st[cx] = MQ_NLPS[s]
            else:
                d = mps[cx]
                st[cx] = MQ_NMPS[s]
        ct = reg[2]
        while True:
            if ct == 0:
                reg[1] = c
                bytein()
                c, ct = reg[1], reg[2]
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        reg[0], reg[1], reg[2] = a, c, ct
        return d

    def raw():
        if reg[2] == 0:
            if reg[1] == 0xFF:
                if byte(reg[3]) > 0x8F:
                    reg[1] = 0xFF
                    reg[2] = 8
                else:
                    reg[1] = byte(reg[3])
                    reg[3] += 1
                    reg[2] = 7
            else:
                reg[1] = byte(reg[3])
                reg[3] += 1
                reg[2] = 8
        reg[2] -= 1
        return (reg[1] >> reg[2]) & 1

    def set_sig(fi, neg, ci):
        f = flags
        f[fi] |= F_SIG
        f[fi - 1] |= F_E | (G_E if neg else 0)
        f[fi + 1] |= F_W | (G_W if neg else 0)
        if not (ci == 0 and vsc):
            f[fi - W2] |= F_S | (G_S if neg else 0)
            f[fi - W2 - 1] |= F_SE
            f[fi - W2 + 1] |= F_SW
        f[fi + W2] |= F_N | (G_N if neg else 0)
        f[fi + W2 - 1] |= F_NE
        f[fi + W2 + 1] |= F_NW

    def decode_sign(fi, is_raw):
        if is_raw:
            return raw()
        cx, spb = SC_LUT[_sc_index(flags[fi])]
        return decode(cx) ^ spb

    def sigpass(oph, is_raw):
        for _, cols in stripes:
            for col in cols:
                for fi, di, ci in col:
                    f = flags[fi]
                    if f & (F_SIG | F_PI) or not f & F_NEIGH:
                        continue
                    v = raw() if is_raw else decode(zc[f & 0xFF])
                    if v:
                        neg = decode_sign(fi, is_raw)
                        data[di] = -oph if neg else oph
                        set_sig(fi, neg, ci)
                    flags[fi] |= F_PI

    def refpass(poshalf, is_raw):
        for _, cols in stripes:
            for col in cols:
                for fi, di, ci in col:
                    f = flags[fi]
                    if (f & (F_SIG | F_PI)) != F_SIG:
                        continue
                    if is_raw:
                        v = raw()
                    else:
                        v = decode(16 if f & F_MU else (15 if f & F_NEIGH else 14))
                    d = data[di]
                    data[di] = d + (poshalf if (v ^ (d < 0)) else -poshalf)
                    flags[fi] |= F_MU

    def clnpass(oph):
        for full, cols in stripes:
            for col in cols:
                start = 0
                if full and not any(flags[fi] & (F_NEIGH | F_SIG | F_PI) for fi, _, _ in col):
                    if not decode(CTX_AGG):
                        continue
                    r = decode(CTX_UNI)
                    r = (r << 1) | decode(CTX_UNI)
                    fi, di, ci = col[r]
                    neg = decode_sign(fi, False)
                    data[di] = -oph if neg else oph
                    set_sig(fi, neg, ci)
                    start = r + 1
                for fi, di, ci in col[start:]:
                    f = flags[fi]
                    if start == 0 and f & (F_SIG | F_PI):
                        continue
                    if decode(zc[f & 0xFF]):
                        neg = decode_sign(fi, False)
                        data[di] = -oph if neg else oph
                        set_sig(fi, neg, ci)
                for fi, _, _ in col:
                    flags[fi] &= ~F_PI
        if cblksty & SEGSYM:
            for _ in range(4):
                decode(CTX_UNI)

    if counts is not None:
        counted_decode, counted_raw = decode, raw

        def decode(cx):
            counts["decisions"] = counts.get("decisions", 0) + 1
            return counted_decode(cx)

        def raw():
            counts["decisions"] = counts.get("decisions", 0) + 1
            return counted_raw()

    passtype = 2
    pos = start
    for seglen, npasses in segs:
        is_raw = (bpno_plus_one <= numbps - 4) and passtype < 2 and bool(cblksty & LAZY)
        (init_raw if is_raw else init_mq)(pos, pos + seglen)
        pos += seglen
        for _ in range(npasses):
            if bpno_plus_one < 1:
                break
            one = 1 << bpno_plus_one
            oph = one | (one >> 1)
            if passtype == 0:
                sigpass(oph, is_raw)
            elif passtype == 1:
                refpass(one >> 1, is_raw)
            else:
                clnpass(oph)
            if cblksty & RESET and not is_raw:
                reset_ctx()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
    if roishift:
        if roishift >= 31:
            return [0] * (w * h)
        thresh = 1 << roishift
        for i, v in enumerate(data):
            mag = -v if v < 0 else v
            if mag >= thresh:
                mag >>= roishift
                data[i] = -mag if v < 0 else mag
    return data


# ------------------------------------------------------------- the launch

DESC_FIELDS = ("data_off", "seg_off", "nsegs", "w", "h", "orient", "numbps", "roishift", "cblksty", "out_off",
               "out_stride", "nbytes")
N_DESC = len(DESC_FIELDS)
SEG_CAP = 16384   # K5 copies a block's bytes into shared memory up to this; a larger block reads global memory


class Blocks:
    """Every code block of one image, laid out for one K5 launch."""

    def __init__(self, data: np.ndarray, segs: np.ndarray, desc: np.ndarray):
        self.data, self.segs, self.desc = data, segs, desc

    def __len__(self) -> int:
        return len(self.desc)

    @property
    def nbytes(self) -> int:
        """The blocks' segment bytes (without the alignment padding)."""
        return int(self.desc[:, 11].sum())


def pack_blocks(blocks) -> Blocks:
    """`blocks`: (chunks, [(len, passes)], w, h, orient, numbps, roishift,
    cblksty, out_off, out_stride) a code block. They are laid out heaviest
    first (segment bytes x passes, ties in their given order), so K5's
    longest chains start first; each keeps its own out_off and stride, so
    the order changes nothing in the output. Each block's bytes start on a
    16-byte boundary (K5 copies them into shared memory 16 at a time)."""
    work = [len(b"".join(b[0])) * sum(p for _, p in b[1]) for b in blocks]
    order = sorted(range(len(blocks)), key=lambda k: -work[k])
    datas: List[bytes] = []
    segs: List[int] = []
    desc = np.zeros((len(blocks), N_DESC), np.int32)
    at = 0
    for k, src in enumerate(order):
        chunks, bsegs, w, h, orient, numbps, roishift, cblksty, out_off, out_stride = blocks[src]
        blob = b"".join(chunks)
        desc[k] = (at, len(segs) // 2, len(bsegs), w, h, orient, numbps, roishift, cblksty, out_off, out_stride,
                   len(blob))
        for seglen, npasses in bsegs:
            segs += (seglen, npasses)
        blob += b"\0" * (-len(blob) % 16)
        datas.append(blob)
        at += len(blob)
    data = np.frombuffer(bytearray(b"".join(datas) + b"\0" * 16), np.uint8)
    return Blocks(data, np.asarray(segs or [0], np.int32), desc)


def k5_buffers(blocks: Blocks) -> Tuple[int, int, int]:
    """Each K5 warp's shared buffers for these blocks: segment bytes (a
    multiple of 16: the largest block's, at most SEG_CAP), coefficients
    and flags (the largest block's)."""
    live = blocks.desc[blocks.desc[:, 2] > 0]
    if not len(live):
        return 0, 1, 1
    w, h = live[:, 3].astype(np.int64), live[:, 4].astype(np.int64)
    seg_cap = min(int(live[:, 11].max()), SEG_CAP)
    return -(-seg_cap // 16) * 16, int((w * h).max()), int(((w + 2) * (h + 2)).max())


def decode_blocks_plain(blocks: Blocks, out: np.ndarray) -> None:
    """Every block into `out` (int32, flat) with `decode_block`."""
    buf = blocks.data.tobytes()
    segs = blocks.segs
    for d in blocks.desc.tolist():
        data_off, seg_off, nsegs, w, h, orient, numbps, roishift, cblksty, out_off, stride, _ = d
        bsegs = [(int(segs[2 * (seg_off + s)]), int(segs[2 * (seg_off + s) + 1])) for s in range(nsegs)]
        vals = decode_block(buf, data_off, bsegs, w, h, orient, numbps, roishift, cblksty)
        if w > 0 and h > 0 and nsegs:
            v = np.asarray(vals, np.int32).reshape(h, w)
            idx = out_off + np.arange(h)[:, None] * stride + np.arange(w)[None, :]
            out[idx] = v


def j2k_t1_decode(blocks: Blocks, n_total: int, device) -> torch.Tensor:
    """All code blocks of one image -> an int32 tensor of `n_total`
    coefficients on `device` (zeros where no block writes). On the CPU the
    plain version; on a CUDA device K5, one launch."""
    device = torch.device(device)
    if len(blocks) and int((blocks.desc[:, 6] + blocks.desc[:, 7]).max()) >= 31:
        raise ValueError("JPEG 2000: a code block with 31 or more bit planes (OpenJPEG refuses it)")
    if device.type == "cpu":
        out = np.zeros(n_total, np.int32)
        decode_blocks_plain(blocks, out)
        return torch.from_numpy(out)
    if device.type != "cuda":
        raise ValueError(f"K5 runs on a CUDA device or the CPU, not {device}")
    from morphik_core_tpu_torch.ops import _kernels

    data = torch.from_numpy(blocks.data).to(device)
    segs = torch.from_numpy(blocks.segs).to(device)
    desc = torch.from_numpy(np.ascontiguousarray(blocks.desc)).to(device)
    out = torch.zeros(max(n_total, 1), dtype=torch.int32, device=device)
    if len(blocks):
        next_block = torch.empty(1, dtype=torch.int32, device=device)
        _kernels.launch_j2k_t1(data, segs, desc, out, next_block, len(blocks), k5_buffers(blocks))
    return out[:n_total]


__all__ = ["Blocks", "DESC_FIELDS", "SEG_CAP", "decode_block", "decode_blocks_plain", "j2k_t1_decode", "k5_buffers",
           "pack_blocks"]
