"""The safetensors format, read and written without the `safetensors`
package (the card's machine has neither it nor `ml_dtypes`).

A file is a u64 little-endian header length, a JSON header (per tensor
its dtype, shape and `data_offsets` into the data; an optional
`__metadata__` of strings) padded with spaces to 8 bytes, then the raw
little-endian tensors. The reader maps each tensor with its own
`np.memmap`, so a tensor bound for the card goes there straight from the
mapping (never a second host copy) and its pages are unmapped once it
is read. BF16 has no numpy dtype: it is read as 16-bit words and viewed
as `torch.bfloat16`.

`save_file` writes the bytes the package's `save_file` writes for the
same tensors (tensors sorted by dtype, widest first, then by name);
`CheckpointDir` reads every `*.safetensors` of a directory and checks
`model.safetensors.index.json` against them when present.
"""

from __future__ import annotations

import json
import struct
import warnings
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

#: the dtypes read and written: storage numpy dtype, torch dtype, and the
#: rank of the package's Dtype enum (its sort key, widest first)
DTYPES: Dict[str, Tuple[np.dtype, torch.dtype, int]] = {
    "U8": (np.dtype("u1"), torch.uint8, 0),
    "I8": (np.dtype("i1"), torch.int8, 1),
    "F16": (np.dtype("<f2"), torch.float16, 2),
    "BF16": (np.dtype("<i2"), torch.bfloat16, 3),  # 16-bit words, viewed as bf16
    "I32": (np.dtype("<i4"), torch.int32, 4),
    "F32": (np.dtype("<f4"), torch.float32, 5),
    "I64": (np.dtype("<i8"), torch.int64, 6),
}
_CODE_OF = {torch_dtype: code for code, (_, torch_dtype, _) in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


class SafetensorsFile:
    """One safetensors file: its header, checked, and its tensors on demand."""

    def __init__(self, path):
        self.path = Path(path)
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{self.path}: header length {n} past the end of the file")
            try:
                header = json.loads(f.read(n).decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{self.path}: header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{self.path}: header is not a JSON object")
        header.pop("__metadata__", None)
        self.data_start = 8 + n
        self.entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        spans = []
        for name, info in header.items():
            dtype, shape, offsets = info.get("dtype"), info.get("shape"), info.get("data_offsets")
            if dtype not in DTYPES:
                raise ValueError(f"{self.path}: {name}: dtype {dtype!r} not read (only {sorted(DTYPES)})")
            begin, end = offsets
            nbytes = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype][0].itemsize
            if end - begin != nbytes:
                raise ValueError(f"{self.path}: {name}: {end - begin} bytes for {dtype} {shape}")
            self.entries[name] = (dtype, tuple(int(d) for d in shape), begin, end)
            spans.append((begin, end))
        # the tensors tile the data region exactly, as the package requires
        pos = 0
        for begin, end in sorted(spans):
            if begin != pos:
                raise ValueError(f"{self.path}: tensor data not contiguous at byte {pos}")
            pos = end
        if self.data_start + pos != size:
            raise ValueError(f"{self.path}: {size - self.data_start} data bytes, the header describes {pos}")

    def keys(self):
        return self.entries.keys()

    def dtype(self, name: str) -> str:
        return self.entries[name][0]

    def array(self, name: str) -> np.ndarray:
        """A read-only map of the tensor in its storage dtype (BF16 as
        int16). Copy it before writing or handing it to torch on the CPU."""
        dtype, shape, begin, end = self.entries[name]
        np_dtype = DTYPES[dtype][0]
        if begin == end:
            return np.empty(shape, np_dtype)
        return np.memmap(self.path, dtype=np_dtype, mode="r", offset=self.data_start + begin, shape=shape)

    def tensor(self, name: str, device=None) -> torch.Tensor:
        """The tensor on `device` (the CPU by default), BF16 as
        torch.bfloat16. A CPU tensor is a copy; for another device the
        mapping is the source of the transfer."""
        arr = self.array(name)
        device = torch.device(device) if device is not None else torch.device("cpu")
        if device.type == "cpu":
            t = torch.from_numpy(np.array(arr))
        else:
            with warnings.catch_warnings():  # read-only source, only read by the copy to the device
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(arr).to(device)
        return t.view(torch.bfloat16) if self.dtype(name) == "BF16" else t


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, by name, on the CPU."""
    sf = SafetensorsFile(path)
    return {name: sf.tensor(name) for name in sf.keys()}


def _header(tensors: Dict[str, torch.Tensor], metadata: Optional[Dict[str, str]]):
    """(header bytes, names in data order), as the package lays them out."""
    for name, t in tensors.items():
        if t.dtype not in _CODE_OF:
            raise ValueError(f"{name}: dtype {t.dtype} not written (only {sorted(DTYPES)})")
    order = sorted(tensors, key=lambda k: (-DTYPES[_CODE_OF[tensors[k].dtype]][2], k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    pos = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODE_OF[t.dtype], "shape": list(t.shape), "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    raw += b" " * ((8 - len(raw) % 8) % 8)
    return raw, order


def save_file(tensors: Dict[str, torch.Tensor], path, metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any device) as one safetensors file; returns the
    data bytes written."""
    raw, order = _header(tensors, metadata)
    total = 0
    with open(Path(path), "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel() == 0:
                continue
            data = t.view(torch.uint8).numpy()
            f.write(memoryview(data))
            total += data.nbytes
    return total


class CheckpointDir(Mapping):
    """The tensors of every `*.safetensors` in a directory, read on demand
    (`state[name]` is a host tensor; `tensor(name, device)` puts it on a
    device). A name in two files, or an index json that disagrees with
    the files, raises."""

    def __init__(self, path):
        self.path = Path(path)
        files = sorted(self.path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors in {self.path}")
        self._file_of: Dict[str, SafetensorsFile] = {}
        for f in files:
            sf = SafetensorsFile(f)
            for name in sf.keys():
                if name in self._file_of:
                    raise ValueError(f"{name} is in both {self._file_of[name].path.name} and {f.name}")
                self._file_of[name] = sf
        index = self.path / INDEX_FILE
        if index.exists():
            weight_map = json.loads(index.read_text()).get("weight_map")
            have = {name: sf.path.name for name, sf in self._file_of.items()}
            if weight_map != have:
                bad = sorted(set(weight_map or {}) ^ set(have)) or sorted(
                    k for k in have if weight_map[k] != have[k])
                raise ValueError(f"{index.name} disagrees with the files, e.g. {bad[:5]}")

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._file_of[name].tensor(name)

    def tensor(self, name: str, device=None) -> torch.Tensor:
        return self._file_of[name].tensor(name, device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._file_of)

    def __len__(self) -> int:
        return len(self._file_of)

    def __contains__(self, name) -> bool:
        return name in self._file_of
