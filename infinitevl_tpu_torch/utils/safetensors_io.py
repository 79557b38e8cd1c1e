"""A reader and writer of the safetensors format, with torch alone (the
port needs neither the `safetensors` nor the `transformers` package).

A file is an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__": {str: str}}), then the tensors' raw little-endian bytes,
the offsets counted from the end of the header. bf16 is read and written
as torch.bfloat16 directly. The writer stores each tensor's contiguous
bytes (a transposed view is materialised first, never written as its
storage) and pads the header with spaces to a multiple of 8 bytes, as the
reference implementation does."""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _header(path: str) -> Tuple[Dict, int]:
    """(header dict, byte offset of the data) of one file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    return _header(path)[0].get("__metadata__", {}) or {}


def iter_file(path: str, device=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every tensor of one file, in the order of their
    bytes in the file (one sequential read), each on `device` (default:
    the CPU)."""
    header, start = _header(path)
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: kv[1]["data_offsets"][0])
    with open(path, "rb") as f:
        for name, info in entries:
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, "
                                 f"not one of {sorted(_DTYPES)}")
            begin, end = info["data_offsets"]
            raw = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(start + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} is cut short")
            t = raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"])
            yield name, t if device is None else t.to(device)


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any devices) to one file; returns the bytes of
    tensor data written. Tensors are laid out in the order given."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            if host.numel():
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)
    return offset
