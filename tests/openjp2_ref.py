"""The `libopenjp2` 2.5.4 that Pillow bundles, through ctypes: the
reference planes of a JPEG 2000 codestream (`opj_decode`), and an
encoder for what `Image.save` does not expose (code-block styles, SOP /
EPH, POC, an RGN shift, subsampling, precisions 1-16, signed samples).
Test helper; needs PIL's wheel."""

from __future__ import annotations

import ctypes
import glob
import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import PIL

_LIB = None


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        path = sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))[0]
        L = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, args, res in [
            ("opj_create_decompress", [ci], vp), ("opj_create_compress", [ci], vp),
            ("opj_stream_create_default_file_stream", [ctypes.c_char_p, ci], vp),
            ("opj_set_default_decoder_parameters", [vp], None), ("opj_setup_decoder", [vp, vp], ci),
            ("opj_read_header", [vp, vp, ctypes.POINTER(vp)], ci), ("opj_decode", [vp, vp, vp], ci),
            ("opj_end_decompress", [vp, vp], ci), ("opj_stream_destroy", [vp], None),
            ("opj_destroy_codec", [vp], None), ("opj_image_destroy", [vp], None),
            ("opj_set_default_encoder_parameters", [vp], None), ("opj_setup_encoder", [vp, vp, vp], ci),
            ("opj_image_create", [ctypes.c_uint32, vp, ci], vp), ("opj_start_compress", [vp, vp, vp], ci),
            ("opj_encode", [vp, vp], ci), ("opj_end_compress", [vp, vp], ci),
            ("opj_set_MCT", [vp, vp, vp, ctypes.c_uint32], ci),
        ]:
            fn = getattr(L, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = L
    return _LIB


class ImageComp(ctypes.Structure):
    _fields_ = [("dx", ctypes.c_uint32), ("dy", ctypes.c_uint32), ("w", ctypes.c_uint32), ("h", ctypes.c_uint32),
                ("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("prec", ctypes.c_uint32),
                ("bpp", ctypes.c_uint32), ("sgnd", ctypes.c_uint32), ("resno_decoded", ctypes.c_uint32),
                ("factor", ctypes.c_uint32), ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class OpjImage(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


class CompParm(ctypes.Structure):
    _fields_ = [("dx", ctypes.c_uint32), ("dy", ctypes.c_uint32), ("w", ctypes.c_uint32), ("h", ctypes.c_uint32),
                ("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("prec", ctypes.c_uint32),
                ("bpp", ctypes.c_uint32), ("sgnd", ctypes.c_uint32)]


def opj_planes(codestream: bytes, jp2: bool = False) -> Optional[List[np.ndarray]]:
    """`opj_decode` of the bytes: each component's int32 plane, or None
    where OpenJPEG fails."""
    L = lib()
    with tempfile.NamedTemporaryFile(suffix=".jp2" if jp2 else ".j2k", delete=False) as f:
        f.write(codestream)
        path = f.name
    try:
        codec = L.opj_create_decompress(2 if jp2 else 0)
        params = ctypes.create_string_buffer(1 << 16)
        L.opj_set_default_decoder_parameters(params)
        L.opj_setup_decoder(codec, params)
        stream = L.opj_stream_create_default_file_stream(path.encode(), 1)
        img = ctypes.c_void_p()
        ok = L.opj_read_header(stream, codec, ctypes.byref(img))
        ok = ok and L.opj_decode(codec, stream, img) and L.opj_end_decompress(codec, stream)
        out = None
        if ok:
            im = ctypes.cast(img, ctypes.POINTER(OpjImage)).contents
            out = []
            for c in range(im.numcomps):
                comp = im.comps[c]
                n = comp.w * comp.h
                out.append(np.ctypeslib.as_array(comp.data, (n,)).reshape(comp.h, comp.w).copy())
        if img:
            L.opj_image_destroy(img)
        L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec)
        return out
    finally:
        os.unlink(path)


# ------------------------------------------------------------------ encoder

# byte offsets in opj_cparameters_t (openjpeg.h 2.5)
_POC_SIZE = 148
_OFF = {}


def _layout():
    """Field offsets of opj_cparameters_t, checked against the defaults
    `opj_set_default_encoder_parameters` writes."""
    if _OFF:
        return _OFF
    at = 0
    def field(name, size, align=4):
        nonlocal at
        at = (at + align - 1) // align * align
        _OFF[name] = at
        at += size
    for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy", "cp_disto_alloc", "cp_fixed_alloc",
              "cp_fixed_quality"):
        field(n, 4)
    field("cp_matrice", 8, 8)
    field("cp_comment", 8, 8)
    field("csty", 4)
    field("prog_order", 4)
    field("POC", _POC_SIZE * 32)
    field("numpocs", 4)
    field("tcp_numlayers", 4)
    field("tcp_rates", 400)
    field("tcp_distoratio", 400)
    for n in ("numresolution", "cblockw_init", "cblockh_init", "mode", "irreversible", "roi_compno", "roi_shift",
              "res_spec"):
        field(n, 4)
    field("prcw_init", 4 * 33)
    field("prch_init", 4 * 33)
    field("infile", 4096, 1)
    field("outfile", 4096, 1)
    field("index_on", 4)
    field("index", 4096, 1)
    for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx", "subsampling_dy", "decod_format",
              "cod_format"):
        field(n, 4)
    field("jpwl", 4 * (1 + 1 + 16 + 16 + 16 + 16 + 16 + 1 + 1 + 1 + 1 + 16 + 16))
    field("cp_cinema", 4)
    field("max_comp_size", 4)
    field("cp_rsiz", 4)
    field("tp_on", 1, 1)
    field("tp_flag", 1, 1)
    field("tcp_mct", 1, 1)
    return _OFF


def _i32(buf, name, value=None, index=0):
    off = _layout()[name] + 4 * index
    if value is None:
        return int.from_bytes(buf[off:off + 4], "little", signed=True)
    buf[off:off + 4] = int(value).to_bytes(4, "little", signed=True)


def _f32(buf, name, value, index=0):
    off = _layout()[name] + 4 * index
    buf[off:off + 4] = np.float32(value).tobytes()


def opj_encode(planes: Sequence[np.ndarray], prec: Sequence[int], sgnd: Sequence[bool] = None,
               dxdy: Sequence[Tuple[int, int]] = None, *, jp2: bool = False, color_space: int = 0,
               irreversible: bool = False, mct: int = 0, numres: int = 3, cblk: Tuple[int, int] = (64, 64),
               mode: int = 0, csty: int = 0, prog: int = 0, layers: Sequence[float] = (0,),
               precincts: Sequence[Tuple[int, int]] = (), tiles: Tuple[int, int] = None,
               tile_offset: Tuple[int, int] = (0, 0), offset: Tuple[int, int] = (0, 0),
               pocs: Sequence[Tuple[int, int, int, int, int, int]] = (), roi: Tuple[int, int] = None,
               custom_mct: Tuple[np.ndarray, Sequence[int]] = None) -> bytes:
    """Encode with libopenjp2. `planes` are each component's samples at its
    own size; `pocs` are (resno0, compno0, layno1, resno1, compno1, prg);
    `custom_mct` (an n x n matrix, n DC shifts) goes through `opj_set_MCT`
    (Part 2: the MCT, MCC and MCO markers, COD mct 2, Rsiz 0x8100, 9/7)."""
    L = lib()
    n = len(planes)
    sgnd = sgnd or [False] * n
    dxdy = dxdy or [(1, 1)] * n
    parms = (CompParm * n)()
    for c, p in enumerate(planes):
        dx, dy = dxdy[c]
        parms[c].dx, parms[c].dy = dx, dy
        parms[c].w, parms[c].h = p.shape[1], p.shape[0]
        parms[c].x0, parms[c].y0 = -(-offset[0] // dx), -(-offset[1] // dy)
        parms[c].prec, parms[c].bpp, parms[c].sgnd = prec[c], prec[c], int(sgnd[c])
    img = L.opj_image_create(n, ctypes.cast(parms, ctypes.c_void_p), color_space)
    im = ctypes.cast(img, ctypes.POINTER(OpjImage)).contents
    im.x0, im.y0 = offset
    dx0, dy0 = dxdy[0]
    im.x1 = offset[0] + planes[0].shape[1] * dx0
    im.y1 = offset[1] + planes[0].shape[0] * dy0
    for c, p in enumerate(planes):
        dst = np.ctypeslib.as_array(im.comps[c].data, (p.size,))
        dst[:] = p.astype(np.int32).ravel()
    buf = ctypes.create_string_buffer(1 << 16)
    L.opj_set_default_encoder_parameters(buf)
    raw = bytearray(buf.raw)
    assert _i32(raw, "numresolution") == 6 and _i32(raw, "cblockw_init") == 64
    assert _i32(raw, "roi_compno") == -1 and _i32(raw, "subsampling_dx") == 1 and _i32(raw, "decod_format") == -1
    assert _i32(raw, "cod_format") == -1, "opj_cparameters_t layout"
    _i32(raw, "numresolution", numres)
    _i32(raw, "cblockw_init", cblk[0])
    _i32(raw, "cblockh_init", cblk[1])
    _i32(raw, "mode", mode)
    _i32(raw, "irreversible", int(irreversible))
    _i32(raw, "csty", csty)
    _i32(raw, "prog_order", prog)
    _i32(raw, "tcp_numlayers", len(layers))
    for k, r in enumerate(layers):
        _f32(raw, "tcp_rates", r, k)
    _i32(raw, "cp_disto_alloc", 1)
    if precincts:
        _i32(raw, "res_spec", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            _i32(raw, "prcw_init", pw, k)
            _i32(raw, "prch_init", ph, k)
        _i32(raw, "csty", csty | 1)
    if tiles:
        _i32(raw, "tile_size_on", 1)
        _i32(raw, "cp_tdx", tiles[0])
        _i32(raw, "cp_tdy", tiles[1])
        _i32(raw, "cp_tx0", tile_offset[0])
        _i32(raw, "cp_ty0", tile_offset[1])
    _i32(raw, "image_offset_x0", offset[0])
    _i32(raw, "image_offset_y0", offset[1])
    if roi:
        _i32(raw, "roi_compno", roi[0])
        _i32(raw, "roi_shift", roi[1])
    if pocs:
        base = _layout()["POC"]
        for k, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
            at = base + k * _POC_SIZE
            vals = [r0, c0, l1, r1, c1]   # resno0, compno0, layno1, resno1, compno1
            for j, v in enumerate(vals):
                raw[at + 4 * j:at + 4 * j + 4] = int(v).to_bytes(4, "little")
            raw[at + 32:at + 36] = int(prg).to_bytes(4, "little", signed=True)   # prg1
            raw[at + 36:at + 40] = int(prg).to_bytes(4, "little", signed=True)   # prg
            raw[at + 48:at + 52] = (1).to_bytes(4, "little")                    # tile (from 1)
        _i32(raw, "numpocs", len(pocs))
    raw[_layout()["tcp_mct"]] = mct
    buf = ctypes.create_string_buffer(bytes(raw), len(raw))
    if custom_mct is not None:
        matrix = np.ascontiguousarray(custom_mct[0], np.float32)
        shifts = np.ascontiguousarray(custom_mct[1], np.int32)
        assert L.opj_set_MCT(buf, matrix.ctypes.data, shifts.ctypes.data, n), "opj_set_MCT failed"
    codec = L.opj_create_compress(2 if jp2 else 0)
    assert L.opj_setup_encoder(codec, buf, img), "opj_setup_encoder failed"
    with tempfile.NamedTemporaryFile(suffix=".jp2" if jp2 else ".j2k", delete=False) as f:
        path = f.name
    try:
        stream = L.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = L.opj_start_compress(codec, img, stream) and L.opj_encode(codec, stream) and \
            L.opj_end_compress(codec, stream)
        L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec)
        L.opj_image_destroy(img)
        assert ok, "libopenjp2 failed to encode"
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
