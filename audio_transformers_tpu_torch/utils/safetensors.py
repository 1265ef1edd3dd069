"""Read and write the safetensors format without the `safetensors` package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes. The header maps each tensor name to
{"dtype", "shape", "data_offsets": [begin, end]} (offsets into the byte
buffer after the header) and may hold a "__metadata__" map of strings;
writers pad it with spaces to a multiple of 8 bytes. The card's machine
has no `safetensors` package, so HF directories cross between the two
packages through this module.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["load_file", "save_file"]

# safetensors dtype name -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a .safetensors file, each tensor in its stored
    dtype on the CPU. Raises ValueError on a dtype other than F32, F16,
    BF16, I32 or I64 and on a header that does not fit the file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path!r} is too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path!r}: header length {n} exceeds the file")
    header = json.loads(data[8:8 + n])
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path!r}: tensor {name!r} has dtype "
                             f"{info['dtype']}; this reader takes "
                             f"{sorted(_DTYPES)}")
        np_dtype, dtype = _DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        size = (int(np.prod(shape, dtype=np.int64))
                * np.dtype(np_dtype).itemsize)
        if not 0 <= begin <= end <= len(buf) or end - begin != size:
            raise ValueError(f"{path!r}: tensor {name!r} has offsets "
                             f"[{begin}, {end}] for {size} bytes in a "
                             f"buffer of {len(buf)}")
        arr = np.frombuffer(buf[begin:end], dtype=np.dtype(np_dtype)
                            .newbyteorder("<")).astype(np_dtype)
        out[name] = torch.from_numpy(arr).view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str, *,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Writes {name: tensor} (F32, F16, BF16, I32 or I64; any device) to
    `path`. Tensors go by descending item size, then name, so that each
    starts on a multiple of its item size, as the safetensors writer
    lays them out."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, chunks, offset = {}, [], 0
    for name in order:
        t = tensors[name].detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; this "
                             f"writer takes {sorted(_DTYPES)}")
        raw = t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy() \
            .tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    if metadata is not None:
        header = {"__metadata__": {str(k): str(v)
                                   for k, v in metadata.items()}, **header}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
