"""JPEG 2000 Part 15 (HTJ2K) block decoding: each high-throughput code
block's cleanup, SigProp and MagRef passes into signed coefficients, as
OpenJPEG 2.5.4's `ht_dec.c::opj_t1_ht_decode_cblk` decodes them; and K6,
its kernel for the card (`csrc/j2k_ht.cu`).

The cleanup segment (`Lcup` bytes, its last 12 bits `Scup`) holds three
streams: MagSgn forward from byte 0 (0xFF past its end), MEL forward from
`Lcup - Scup` (0xFF past its end, the low nibble of byte `Lcup - 2` read as
0xF) and VLC backward from byte `Lcup - 2`'s high nibble (zeros past its
start). Quads (2 x 2) are decoded in pairs along each pair of rows: a VLC
codeword (`VLC_TBL0` on the first row pair, `VLC_TBL1` after, indexed by
the quad's context and seven stream bits) gives the significance pattern,
`u_off` and the EMB bits; a MEL event stands in for quads of context 0;
the UVLC gives `u`, and the exponents of the row above `kappa`; each
significant sample takes `U_q - e_k` MagSgn bits. The refinement segment
holds SigProp forward (zeros past its end) and MagRef backward from its
last byte, decoded a stripe of four rows at a time: MagRef one bit a
cleanup-significant sample, SigProp one bit a sample next to a
significant one (the next stripe's not counted under VSC), then the signs
of those that became significant, four columns at a time. Bit unstuffing
as OpenJPEG does it: after 0xFF the next byte gives 7 bits (MagSgn,
SigProp, MEL); backward, after a byte above 0x8F a byte whose low 7 bits
are all set gives 7 (VLC, MagRef).

The coefficients are in OpenJPEG's t1 representation, the one K5 writes
(`jpeg2000_t1.py`): with `p` = the block's `numbps` (the band's bit planes
+ 1 - the missing MSBs, for HT the planes below the cleanup's), a cleanup
magnitude `mu` is `mu << p` plus the half `1 << (p - 1)`; MagRef sets or
clears bit `p - 1` and adds the half `1 << (p - 2)`; SigProp's new samples
are `3 << (p - 2)`. OpenJPEG's limits, each an error (`ValueError`) but
the two it warns about: an ROI shift; more than three passes; more than
30 bit planes; more missing MSBs than bit planes; refinement passes with
an empty segment, or when the missing MSBs equal the bit planes, are
dropped (the cleanup alone decodes); `2 <= Scup <= min(Lcup, 4079)`; a
MEL byte above 0x8F after 0xFF in its first four bytes (OpenJPEG checks
the bytes up to its first aligned word: here the MEL is taken to start
on a 4-byte boundary); a `U_q` above the missing MSBs + 1; a VLC codeword
significant outside the block.

`pack_ht_blocks` lays an image's HT code blocks out for one launch,
heaviest first (one u8 buffer of their data and an int32 descriptor a
block, `HT_DESC_FIELDS`) and `j2k_ht_decode` runs them: on the CPU with
`decode_ht_block` (plain Python, one block after another), on a CUDA
device with K6 (one launch, a warp a block).
"""

from __future__ import annotations

import base64
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.utils.jp2_codestream import VSC

# ht_dec.c's `vlc_tbl0` (first row pair) and `vlc_tbl1` (the others), uint16[1024] each:
# index (context << 7) | 7 VLC bits; entry cwd_len (bits 0-2), u_off (3), rho (4-7),
# e_1 (8-11), e_k (12-15). zlib + base64 of the two arrays, little-endian.
_TABLES = (
    "eNqFl09MW9kVxo/tdJ+nmC4BPcMsh2JEZoeR8mh3EyHhdDUgVamzCwohYWcvHLfeNFEWnYRNkJCgVhagEM0wyQJvSOpFBEIKQyqN"
    "bAmhEEWRn/yH4GHen37nnsv0PS+mCwtdnffd37nnnnvvR4JW6AplKE/1Upxq7xK0dfEK+Sd5yvanaWYyQaOIf23laWc7TrtvEuQd"
    "Ir6Yp2/pFaWGE0o/zfEK9AbibcSdPD2hNC2Q6P1GntaKcdrE2OtcIfsoT/eLr6jPSIT5U8K3TeHnzDC/bAj/lDTfDPMPSPNfCn/2"
    "nP9e+OvLwj8m4Q+ZUcxyD6wo5h/AvFHyli26hr9PiOeLIp97yC8K/QDWF0WeFl3G+D7m6zNEfxPjHcT9IvQ/WMg3ivx4vRgf3UN+"
    "UVqlAXCjVJ2y6EtwxxBfoDDfb4T5ZSPMt80wP2eG+fZRmL++HObX3oX5M5NRVEnmr3L+SXxviH5N558dhh7fvYae61Hvt6jXkPw4"
    "f9ZPT4Fvyfq8huS3yvOnMZ6/R2O8jv4Bys2Ds22R35H8uP5Bvqp/gP+gGObvVsL82S5+bS/M5/oE+WVT+FxH5qeSMaq+ddu+E8c3"
    "afBitJUsYB2DYHpPc3MxzOt2bCtO2esTqGcM836Tri26jcvkncz+Bfo96N8jfitN5Wcx7FOBavuDWIPXzGViyBv6wzhynKAlIwbu"
    "N+nditvoNeqVG6T5LeGXDeHX3gl/yBT+KQl/6bHwD0jzLc1/IfxN0vyfhL9Amn8k/Nxt4Zd/EH4K+73C/TeOulyU/vbmpP/WcB7L"
    "G1wn2Z/Xun/rFekf7j/e/5VA/6n9eyj1X1tG/z3lfsT+8Dni/duG3sL+t9F/ppyfIN9fDPO5/4L8gy7+VSvMtw/D/JwV5i+R5t8V"
    "fmqY61Mg/z9uM3vda5QXUb/lQbIzbvsa1Q+5XluPJ7Aut5Mh7+4S+uN+sQf7u4Icqo+vov5bG9A7bvOm+a3U/+kg+tBtX8bOzl7H"
    "uDRB9ke3M23VP+RuxWgs2YM6rJB/tlP8lb+g+c+Ff0zC5/1jvn0kfO4n5h+Q8FMjmn9H+EsPNX9R+DOTmv9J8+eEX34Gfmun2Id+"
    "q065zV6D+8vr7L7BfA/xvTmI+b0WnwfOj/tv2vCc9RL33yjV0L9jw16G17dTcZv+SRx75LXLL8EzJ9T5GUt6H1X9kF8tHceeZm9J"
    "/49i/dCP1D9w/YJ8rr/iHwpfzk+BVP+CL/0/Stz/im9q/gvhq/qDX9sTvqof+PYn4fP6mc/9z/yZKaeB83N2QE7n9+T6uXmnnb3l"
    "tsrPnab9kfNzGmvm7/C9gzPoOQvktKcN9yR3x2nW3tUPUyNOY2vDPdstOh3/F+hvO+2b5LY2CfqM93Nq2Gk8IehfIu56n29A/wW5"
    "Jw+K0P9UfTtkCn93W/PnNH8R+k/1D38i4f8L+fmnnvNnzX+E+Wv79cOvSPj/5rgHfUb46yWneUzgJzX/mYM7wPuM9Sr+31m/WH3b"
    "Z1yiv+J9rOI9/EcxgTvjknpP14p5VCmBOl/C+3IFd20e92wCe3KJ/olxFmPvYgLnX/Q7RdH3GqKfJtEfa/2W1vuG6Mf4vR9P4D79"
    "bb5t/TZ/8//wd7fD/FMK82cpgtsjgt6IoMMjWG8Et0QEPRKhCfwWdPy1jj8oSvwUv1H8hkyJe+MS39T6stbf0PpVrb9qSfxY61NG"
    "mL/bxZ/t4i/puH2uT4b56zruW6Kf6eLndLym9X2GjJlf0HnH9fpe6/Wr+ToyX07Ha3rO1LDEvzRFv6njNvhry7J+pZ8U/aPAOi+z"
    "3uzib2j9uPBnz/Vzol8K7NNqoJ7n/PWSxLm+zJ/pqgfvn6rTU+Hz++N1BtR78z3fwxm8I/iC/QXfE+ulKH3GDGPD7CcmqPwc78hG"
    "HP44ivsmOzkD3+E1B9R7tGbinrH4nYqr9+0u9Pz+VMehT7JfmRA/iXfLP4vyfdbg9yvItythPvufIL9maX5J+Ox/gvxjEj6/g4o/"
    "F+aXn2n+beGnRqQ/6v0RnBPsy3aELK4X+qpH14vjGfwGdX9x3Dal/uf99bWl9W8kzv3TE+jfa1q/pPXcP94f/nd+fuVXNN8Q/fn5"
    "O+fntP5Y7/9XXfxNHS9rfqqL/0jHDzS/T/v5+6jzj5jBb6GeDt4OtR9p5Ze9jqX8R7a/oPzJezrR/rJH+QmvaaHW7D9fKV/hNQa1"
    "f00rv+q1LeW/ty4WlD+vTp3o/e1R/jfEPwvzy0aYz741yFf+NsjfD/NVfwT47O+CfPYHn1W/cQ4rVHvL/iONdaBnzO9xTmLgcb9z"
    "DgVif/AEedrw2vCfnRz8S/0D4g3OYQX9E6OsibrtDbD/bPP8P6p+5BwK8N8x9X9brcI96zX5/Q7ylX9m/ojmlzT/hfDLJc0/Ej77"
    "D8V3NL8ifPuj8HPzwvfPNH9D8y3hp4Zb5J2xl74A330H9WkpP2If7cMteE7uNuItt9NrXICO/X0L5/M79IXbht94MTOF+F238QX0"
    "q3QH/dBC3eFHTvfpj/DnufkW8nfxtl+gvxH/f9HC+fwO9XDxjtdLKaOLvyd8/xfNt8L83JzwbVP4V60wv2xovi/8VDLMnyXhw/8o"
    "/pD5X+qnNcs="
)
VLC_TABLES = np.frombuffer(zlib.decompress(base64.b64decode("".join(_TABLES))), "<u2").reshape(2, 1024)
VLC_TBL0, VLC_TBL1 = (t.tolist() for t in VLC_TABLES)
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1

# decode_init_uvlc / decode_noninit_uvlc's prefix table: prefix length (bits 0-1),
# suffix length (2-4), prefix value (5-7), by the stream's next three bits
_UVLC = (3 | (5 << 2) | (5 << 5), 1 | (1 << 5), 2 | (2 << 5), 1 | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (1 << 5),
         2 | (2 << 5), 1 | (1 << 5))


def _error(what: str) -> ValueError:
    return ValueError(f"JPEG 2000: malformed HT code block ({what})")


class _Mel:
    """The MEL decoder (`mel_init`, `mel_read`, `mel_decode`, `mel_get_run`):
    runs of events, each `2 * zeros + (ends in a one)`."""

    def __init__(self, buf: bytes, at: int, size: int):
        self.buf, self.at, self.size = buf, at, size
        self.tmp = self.bits = self.k = 0
        self.unstuff = False
        self.runs: List[int] = []
        for _ in range(4):
            if self.unstuff and buf[self.at] > 0x8F:
                raise _error("incorrect MEL segment sequence")
            d = buf[self.at] if self.size > 0 else 0xFF
            if self.size == 1:
                d |= 0xF
            if self.size > 0:
                self.at += 1
            self.size -= 1
            nb = 8 - self.unstuff
            self.tmp = (self.tmp << nb) | d
            self.bits += nb
            self.unstuff = d == 0xFF
        self.tmp = (self.tmp << (64 - self.bits)) & _M64

    def _read(self) -> None:
        if self.bits > 32:
            return
        val, i = 0xFFFFFFFF, 0
        while self.size > 0 and i < 32:   # four bytes, the last of the segment with its low nibble set
            v = self.buf[self.at] | (0xF if self.size == 1 else 0)
            self.at += 1
            self.size -= 1
            val = (val & ~(0xFF << i) & _M32) | (v << i)
            i += 8
        bits = 32 - self.unstuff
        t = 0
        for k in range(4):   # MSB first; the byte after 0xFF gives 7 bits, its top one over the last bit read
            b = (val >> (8 * k)) & 0xFF
            t |= b
            if k < 3:
                u = b == 0xFF
                bits -= u
                t <<= 8 - u
        self.unstuff = (val >> 24) == 0xFF
        self.tmp = (self.tmp | (t << (64 - bits - self.bits))) & _M64
        self.bits += bits

    def run(self) -> int:
        if not self.runs:
            if self.bits < 6:
                self._read()
            while self.bits >= 6 and len(self.runs) < 8:
                e = MEL_EXP[self.k]
                if self.tmp >> 63:
                    r = ((1 << e) - 1) << 1
                    self.k = min(self.k + 1, 12)
                    self.tmp = (self.tmp << 1) & _M64
                    self.bits -= 1
                else:
                    r = (((self.tmp >> (63 - e)) & ((1 << e) - 1)) << 1) + 1
                    self.k = max(self.k - 1, 0)
                    self.tmp = (self.tmp << (e + 1)) & _M64
                    self.bits -= e + 1
                self.runs.append(r)
        return self.runs.pop(0)


class _Rev:
    """A backward reader (`rev_init` / `rev_init_mrp`, `rev_read`,
    `rev_fetch`, `rev_advance`): bytes from `at` down, zeros past `size`
    of them, 7 bits from a byte whose low 7 bits are set after one above
    0x8F; the VLC's first byte gives its high nibble only."""

    def __init__(self, buf: bytes, at: int, size: int, vlc: bool):
        self.buf, self.at, self.size = buf, at, size
        self.tmp = self.bits = 0
        self.unstuff = True
        if vlc:
            d = buf[at]
            self.at -= 1
            self.tmp = d >> 4
            self.bits = 4 - ((self.tmp & 7) == 7)
            self.unstuff = (d | 0xF) > 0x8F

    def fetch(self) -> int:
        while self.bits < 32:
            if self.size > 0:
                d = self.buf[self.at]
                self.at -= 1
            else:
                d = 0
            self.size -= 1
            self.tmp |= d << self.bits
            self.bits += 8 - (self.unstuff and (d & 0x7F) == 0x7F)
            self.unstuff = d > 0x8F
        return self.tmp & _M32

    def advance(self, n: int) -> int:
        self.tmp >>= n
        self.bits -= n
        return self.fetch()


class _Fwd:
    """A forward reader (`frwd_init`, `frwd_read`, `frwd_fetch`,
    `frwd_advance`): `x` past `size` bytes, 7 bits from the byte after
    0xFF."""

    def __init__(self, buf: bytes, at: int, size: int, x: int):
        self.buf, self.at, self.size, self.x = buf, at, size, x
        self.tmp = self.bits = 0
        self.unstuff = False

    def fetch(self) -> int:
        while self.bits < 32:
            if self.size > 0:
                d = self.buf[self.at]
                self.at += 1
            else:
                d = self.x
            self.size -= 1
            self.tmp |= d << self.bits
            self.bits += 8 - self.unstuff
            self.unstuff = d == 0xFF
        return self.tmp & _M32

    def advance(self, n: int) -> None:
        self.tmp >>= n
        self.bits -= n


def _uvlc(vlc: int, mode: int, initial: bool) -> Tuple[int, int, int]:
    """`decode_init_uvlc` (mode 4: both `u_off` and a MEL event of one) /
    `decode_noninit_uvlc` -> (U_q of each quad with kappa 1, bits used)."""
    if mode == 0:
        return 1, 1, 0
    d1 = _UVLC[vlc & 7]
    vlc >>= d1 & 3
    used = d1 & 3
    s1 = (d1 >> 2) & 7
    if mode <= 2:
        u = (d1 >> 5) + (vlc & ((1 << s1) - 1)) + 1
        return (u, 1, used + s1) if mode == 1 else (1, u, used + s1)
    if initial and mode == 3 and (d1 & 3) > 2:   # u of the first above 2: the second's in one bit
        u1 = (vlc & 1) + 2
        vlc >>= 1
        return (d1 >> 5) + (vlc & ((1 << s1) - 1)) + 1, u1, used + 1 + s1
    d2 = _UVLC[vlc & 7]
    vlc >>= d2 & 3
    s2 = (d2 >> 2) & 7
    used += (d2 & 3) + s1 + s2
    u0 = (d1 >> 5) + (vlc & ((1 << s1) - 1))
    vlc >>= s1
    u1 = (d2 >> 5) + (vlc & ((1 << s2) - 1))
    add = 3 if mode == 4 else 1
    return u0 + add, u1 + add, used


def ht_block_passes(len2: int, npasses: int, numbps: int, mb: int, roishift: int) -> int:
    """The checks `opj_t1_ht_decode_cblk` makes before it reads a bit ->
    the passes it decodes (1 to 3), or 0 where the block stays all zero."""
    if roishift:
        raise ValueError("JPEG 2000: an ROI shift in an HT code block (OpenJPEG does not decode it)")
    if mb == 0:
        return 0
    if npasses > 1 and len2 == 0:
        npasses = 1
    if npasses > 3:
        raise ValueError(f"JPEG 2000: an HT code block of {npasses} coding passes (OpenJPEG decodes at most 3)")
    if mb > 30:
        raise ValueError(f"JPEG 2000: an HT code block of {mb} bit planes (OpenJPEG decodes at most 30)")
    zero = mb + 1 - numbps
    if zero > mb:
        raise _error(f"{zero} zero bit planes in {mb}")
    return 1 if zero == mb else npasses


def decode_ht_block(buf: bytes, start: int, len1: int, len2: int, total: int, npasses: int, w: int, h: int,
                    numbps: int, mb: int, roishift: int, cblksty: int, counts: Optional[dict] = None) -> List[int]:
    """One HT code block (`opj_t1_ht_decode_cblk`): its `total` bytes at
    `buf[start:]`, the cleanup segment (`len1` bytes) then the refinement
    segment (`len2`), `npasses` passes in those two, `numbps` and the
    band's bit planes `mb` as OpenJPEG's tier-2 sets them -> its w * h
    coefficients, row-major. `counts`, where given, gets the cleanup's
    quads ("quads") and the SigProp and MagRef bits read ("sigprop_bits",
    "magref_bits") added."""
    data = [0] * (w * h)
    if w <= 0 or h <= 0:
        return data
    npasses = ht_block_passes(len2, npasses, numbps, mb, roishift)
    if not npasses:
        return data
    if len1 < 2 or len1 > total or len1 + len2 > total:
        raise _error("invalid code-block lengths")
    p = numbps
    zero_p1 = mb + 2 - numbps
    lcup = len1
    scup = (buf[start + lcup - 1] << 4) + (buf[start + lcup - 2] & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise _error("2 <= Scup <= min(Lcup, 4079) is not met")
    mel = _Mel(buf, start + lcup - scup, scup - 1)
    vlc = _Rev(buf, start + lcup - 2, scup - 2, True)
    magsgn = _Fwd(buf, start, lcup - scup, 0xFF)
    sigprop = _Fwd(buf, start + lcup, len2, 0)
    magref = _Rev(buf, start + lcup + len2 - 1, len2, False)
    causal = bool(cblksty & VSC)
    nw = (w + 7) // 8
    sigma = [[0] * (nw + 2), [0] * (nw + 2)]    # cleanup significance, 4 rows x 8 columns a word
    mbrs = [[0] * (nw + 2), [0] * (nw + 2)]     # SigProp membership, likewise
    ls = [0] * (w // 2 + 4)                     # line state: (sigma << 7) | E of the row above, by column pair
    run = 0

    def sample(qinf: int, u_q: int, n: int) -> Tuple[int, int]:
        """Sample n of a significant quad's MagSgn bits -> its word (sign
        in bit 31) and its exponent E."""
        ms = magsgn.fetch()
        m = u_q - ((qinf >> (12 + n)) & 1)
        magsgn.advance(m)
        v = (ms & ((1 << m) - 1)) | (((qinf >> (8 + n)) & 1) << m) | 1
        return ((ms & 1) << 31) | (((v + 2) << (p - 1)) & _M32), v.bit_length()

    def row_pair(y: int) -> None:
        """The cleanup pass over rows y and y + 1."""
        nonlocal run
        initial = y == 0
        tbl = VLC_TBL0 if initial else VLC_TBL1
        sig = sigma[1] if y & 4 else sigma[0]
        shift = 2 if y & 2 else 0
        c_q = li = 0
        ls0 = ls[0]
        ls[0] = 0
        for x in range(0, w, 4):
            qinf = [0, 0]
            vlc_val = vlc.fetch()
            for k in range(2 if x + 2 < w else 1):
                if not initial:   # sigma of NW | N, and of NE | NF, from the line state
                    c_q |= ls0 >> 7 if k == 0 else ls[li + 1] >> 7
                    c_q |= (ls[li + 1 + k] >> 5) & 4
                qinf[k] = tbl[(c_q << 7) | (vlc_val & 0x7F)]
                if c_q == 0:   # a MEL event: is the quad significant?
                    run -= 2
                    if run != -1:
                        qinf[k] = 0
                    if run < 0:
                        run = mel.run()
                if initial:
                    c_q = ((qinf[k] & 0x10) >> 4) | ((qinf[k] & 0xE0) >> 5)
                else:
                    c_q = ((qinf[k] & 0x40) >> 5) | ((qinf[k] & 0x80) >> 6)
                vlc_val = vlc.advance(qinf[k] & 7)
            sh = shift + (16 if x & 4 else 0)
            sig[x >> 3] |= ((((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sh) & _M32
            sig[x >> 3] |= (((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sh)) & _M32
            mode = ((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2)
            if initial and mode == 3:
                run -= 2
                if run == -1:
                    mode = 4
                if run < 0:
                    run = mel.run()
            u0, u1, used = _uvlc(vlc_val, mode, initial)
            if not initial:   # kappa: the largest exponent above a quad of two or more significant samples
                if (qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1):
                    e = max(ls0 & 0x7F, ls[li + 1] & 0x7F)
                    u0 += e - 2 if e > 2 else 0
                if (qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1):
                    e = max(ls[li + 1] & 0x7F, ls[li + 2] & 0x7F)
                    u1 += e - 2 if e > 2 else 0
            if u0 > zero_p1 or u1 > zero_p1:
                raise _error("U_q is larger than the zero bit planes + 1")
            vlc.advance(used)
            if not initial:
                ls0 = ls[li + 2]
                ls[li + 1] = ls[li + 2] = 0
            locs = 0xFF
            if x + 4 > w:
                locs >>= (x + 4 - w) << 1
            if y + 2 > h:
                locs &= 0x55
            if (((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs & 0xFF:
                raise _error("a VLC codeword significant outside the code block")
            for col in range(min(4, w - x)):
                q, n = col >> 1, (col & 1) * 2
                if col & 1:
                    li += 1
                    ls[li] = 0
                at = y * w + x + col
                bit = 1 << (4 * q + n)
                if qinf[q] & (0x10 << n):
                    data[at] = sample(qinf[q], (u0, u1)[q], n)[0]
                elif locs & bit:
                    data[at] = 0
                if qinf[q] & (0x20 << n):
                    data[at + w], e = sample(qinf[q], (u0, u1)[q], n + 1)
                    ls[li] = 0x80 | (e if col & 1 else max(ls[li] & 0x7F, e))
                elif locs & (bit << 1):
                    data[at + w] = 0

    def magref_stripe(y0: int, sig: List[int]) -> None:
        """MagRef over the stripe of rows y0 .. y0 + 3."""
        half = 1 << (p - 2)
        for i in range(0, w, 8):
            cwd = magref.fetch()
            s = sig[i >> 3]
            for j in range(8):
                for r in range(4):
                    if s & (1 << (4 * j + r)):
                        at = (y0 + r) * w + i + j
                        data[at] = (data[at] ^ ((1 - (cwd & 1)) << (p - 1))) | half
                        cwd >>= 1
            magref.advance(bin(s).count("1"))
            if counts is not None:
                counts["magref_bits"] = counts.get("magref_bits", 0) + bin(s).count("1")

    def membership(sig: List[int], mbr: List[int]) -> None:
        """A stripe's insignificant samples next to its significant ones."""
        prev = 0
        for i in range(nw):
            m = sig[i] | (prev >> 28) | ((sig[i] << 4) & _M32) | (sig[i] >> 4) | ((sig[i + 1] << 28) & _M32)
            prev = sig[i]
            m |= ((m & 0x77777777) << 1) | ((m & 0xEEEEEEEE) >> 1)
            mbr[i] = m & ~sig[i] & _M32

    def sigprop_stripe(y0: int, c: int, pattern: int, with_next: bool) -> None:
        """SigProp over the stripe of rows y0 .. y0 + 3 (its sigma and
        membership at index c, the next stripe's at 1 - c)."""
        cur_sig, cur_mbr, nxt_sig, nxt_mbr = sigma[c], mbrs[c], sigma[1 - c], mbrs[1 - c]
        if with_next:
            prev = 0
            for i in range(nw):
                t = nxt_sig[i] | (prev >> 28) | ((nxt_sig[i] << 4) & _M32) | (nxt_sig[i] >> 4) | \
                    ((nxt_sig[i + 1] << 28) & _M32)
                prev = nxt_sig[i]
                if not causal:
                    cur_mbr[i] |= (t & 0x11111111) << 3
                cur_mbr[i] &= ~cur_sig[i] & _M32
        val = 3 << (p - 2)
        for i in range(0, w, 8):
            wi = i >> 3
            mbr = cur_mbr[wi] & pattern
            new_sig = 0
            if mbr:
                inv_sig = ~cur_sig[wi] & pattern   # rows past the block's end never join
                for n in (0, 4):
                    cwd = sigprop.fetch()
                    cnt = 0
                    end = n + 4 if n + 4 + i < w else w - i
                    for j in range(n, end):
                        for r in range(4):
                            sm = 1 << (4 * j + r)
                            if mbr & sm:
                                if cwd & 1:   # significant now: its later neighbours join
                                    new_sig |= sm
                                    mbr |= ((0x32, 0x74, 0xE8, 0xC0)[r] << (4 * j)) & inv_sig
                                cwd >>= 1
                                cnt += 1
                    if new_sig & ((0xFFFF << (4 * n)) & _M32):
                        for j in range(n, end):
                            for r in range(4):
                                if new_sig & (1 << (4 * j + r)):
                                    at = (y0 + r) * w + i + j
                                    data[at] |= ((cwd & 1) << 31) | val
                                    cwd >>= 1
                                    cnt += 1
                    sigprop.advance(cnt)
                    if counts is not None:
                        counts["sigprop_bits"] = counts.get("sigprop_bits", 0) + cnt
                    if n == 4:
                        t = new_sig >> 28
                        t |= ((t & 0xE) >> 1) | ((t & 7) << 1)
                        cur_mbr[wi + 1] |= t & ~cur_sig[wi + 1] & _M32
            new_sig |= cur_sig[wi]
            ux = (new_sig & 0x88888888) >> 3
            tx = ux | ((ux << 4) & _M32) | (ux >> 4)
            if i > 0:
                nxt_mbr[wi - 1] |= ((ux << 28) & _M32) & ~nxt_sig[wi - 1] & _M32
            nxt_mbr[wi] |= tx & ~nxt_sig[wi] & _M32
            nxt_mbr[wi + 1] |= (ux >> 28) & ~nxt_sig[wi + 1] & _M32

    if counts is not None:
        counts["quads"] = counts.get("quads", 0) + ((w + 1) // 2) * ((h + 1) // 2)
    run = mel.run()
    row_pair(0)
    y = 2
    while y < h:
        row_pair(y)
        y += 2
        if npasses > 1 and (y & 3) == 0:
            c = 1 if y & 4 else 0   # the stripe that ended at y is at 1 - c, the one before at c
            if npasses > 2:
                magref_stripe(y - 4, sigma[1 - c])
            membership(sigma[1 - c], mbrs[1 - c])
            if y >= 8:
                sigprop_stripe(y - 8, c, _M32, True)
                sigma[c][:] = [0] * (nw + 2)
    if npasses > 1:
        if h & 3 in (1, 2):
            k = 1 if h & 4 else 0
            if npasses > 2:
                magref_stripe(h & ~3, sigma[k])
            membership(sigma[k], mbrs[k])
        first = h - ((((h + 1) & 3) + 3) if h > 6 else h)
        for y in range(first, h, 4):
            left = h - y
            sigprop_stripe(y, 1 if y & 4 else 0, {3: 0x77777777, 2: 0x33333333, 1: 0x11111111}.get(left, _M32),
                           left > 4)
    for i, v in enumerate(data):
        data[i] = -(v & 0x7FFFFFFF) if v & 0x80000000 else v
    return data


# ------------------------------------------------------------- the launch

# K6's error codes (the kernel stops the block and leaves its code in `errors`)
HT_ERRORS = {1: "2 <= Scup <= min(Lcup, 4079) is not met", 2: "incorrect MEL segment sequence",
             3: "U_q is larger than the zero bit planes + 1", 4: "a VLC codeword significant outside the code block"}
HT_DESC_FIELDS = ("data_off", "len1", "len2", "total", "npasses", "w", "h", "numbps", "mb", "cblksty", "out_off",
                  "out_stride", "work")
N_HT_DESC = len(HT_DESC_FIELDS)
HT_SEG_CAP = 16384   # K6 copies a block's bytes into shared memory up to this; a larger block reads global memory


class HtBlocks:
    """Every HT code block of one image, laid out for one K6 launch."""

    def __init__(self, data: np.ndarray, desc: np.ndarray):
        self.data, self.desc = data, desc

    def __len__(self) -> int:
        return len(self.desc)

    @property
    def nbytes(self) -> int:
        """The blocks' segment bytes (without the alignment padding)."""
        return int(self.desc[:, 3].sum())


def pack_ht_blocks(blocks) -> HtBlocks:
    """`blocks`: (chunks, [(len, passes)], w, h, numbps, mb, roishift,
    cblksty, out_off, out_stride) an HT code block; the checks that need no
    decoding are made here (a block whose passes decode to nothing gets
    none). They are laid out heaviest first (segment bytes x passes, the
    `work` field; ties in their given order), so K6's longest chains start
    first; each keeps its own out_off and stride, so the order changes
    nothing in the output. Each block's bytes start on a 16-byte boundary
    (K6 copies them into shared memory 16 at a time)."""
    rows = []
    for chunks, segs, w, h, numbps, mb, roishift, cblksty, out_off, out_stride in blocks:
        blob = b"".join(chunks)
        len1 = segs[0][0] if segs else 0
        len2 = segs[1][0] if len(segs) > 1 else 0
        npasses = sum(s[1] for s in segs[:2])
        npasses = ht_block_passes(len2, npasses, numbps, mb, roishift) if w > 0 and h > 0 else 0
        if npasses and (len1 < 2 or len1 > len(blob) or len1 + len2 > len(blob)):
            raise _error("invalid code-block lengths")
        rows.append((blob, [len1, len2, len(blob), npasses, w, h, numbps, mb, cblksty, out_off, out_stride,
                            len(blob) * npasses]))
    rows.sort(key=lambda r: -r[1][-1])
    datas: List[bytes] = []
    desc = np.zeros((len(rows), N_HT_DESC), np.int32)
    at = 0
    for k, (blob, fields) in enumerate(rows):
        desc[k] = [at] + fields
        blob += b"\0" * (-len(blob) % 16)
        datas.append(blob)
        at += len(blob)
    data = np.frombuffer(bytearray(b"".join(datas) + b"\0" * 16), np.uint8)
    return HtBlocks(data, desc)


def k6_buffers(blocks: HtBlocks) -> Tuple[int, int, int]:
    """Each K6 warp's shared buffers for these blocks: segment bytes (a
    multiple of 16: the largest block's, at most HT_SEG_CAP), samples and
    columns (the largest block's)."""
    live = blocks.desc[blocks.desc[:, 4] > 0]
    if not len(live):
        return 0, 1, 1
    seg_cap = min(int(live[:, 3].max()), HT_SEG_CAP)
    return -(-seg_cap // 16) * 16, int((live[:, 5].astype(np.int64) * live[:, 6]).max()), int(live[:, 5].max())


def decode_ht_blocks_plain(blocks: HtBlocks, out: np.ndarray) -> None:
    """Every block into `out` (int32, flat) with `decode_ht_block`."""
    buf = blocks.data.tobytes()
    for d in blocks.desc.tolist():
        data_off, len1, len2, total, npasses, w, h, numbps, mb, cblksty, out_off, stride, _ = d
        if not npasses:
            continue
        vals = decode_ht_block(buf, data_off, len1, len2, total, npasses, w, h, numbps, mb, 0, cblksty)
        idx = out_off + np.arange(h)[:, None] * stride + np.arange(w)[None, :]
        out[idx] = np.asarray(vals, np.int64).astype(np.int32).reshape(h, w)


def j2k_ht_decode(blocks: HtBlocks, n_total: int, device, out: torch.Tensor = None) -> torch.Tensor:
    """All HT code blocks of one image -> an int32 tensor of `n_total`
    coefficients on `device`, or written into `out` (K5's buffer, where
    the image mixes both kinds of block). On the CPU the plain version; on
    a CUDA device K6, one launch; a block OpenJPEG fails raises ValueError
    (the first such in the packed order, in both versions)."""
    device = torch.device(device)
    if device.type == "cpu":
        host = np.zeros(n_total, np.int32) if out is None else out.numpy()
        decode_ht_blocks_plain(blocks, host)
        return torch.from_numpy(host) if out is None else out
    if device.type != "cuda":
        raise ValueError(f"K6 runs on a CUDA device or the CPU, not {device}")
    from morphik_core_tpu_torch.ops import _kernels

    if out is None:
        out = torch.zeros(max(n_total, 1), dtype=torch.int32, device=device)
    live = blocks.desc[:, 4] > 0
    if live.any():
        data = torch.from_numpy(blocks.data).to(device)
        desc = torch.from_numpy(np.ascontiguousarray(blocks.desc[live])).to(device)
        next_block = torch.empty(1, dtype=torch.int32, device=device)
        errors = torch.zeros(int(live.sum()), dtype=torch.int32, device=device)
        _kernels.launch_j2k_ht(data, desc, out, next_block, errors, int(live.sum()), k6_buffers(blocks))
        bad = errors.cpu().numpy()
        if bad.any():
            raise _error(HT_ERRORS.get(int(bad[bad != 0][0]), "K6 error"))
    return out[:n_total]


__all__ = ["HT_DESC_FIELDS", "HT_SEG_CAP", "HtBlocks", "VLC_TABLES", "decode_ht_block", "decode_ht_blocks_plain",
           "j2k_ht_decode", "k6_buffers", "pack_ht_blocks"]
