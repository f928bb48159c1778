"""A reader of the safetensors format that needs no ``safetensors`` package.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), then the tensors' raw bytes, each
at ``8 + n + begin``.  :class:`SafetensorsFile` maps the file and gives
each tensor as a ``torch.frombuffer`` view of the mapping: nothing is read
until a tensor's bytes are touched, and the host holds no second copy.
The mapping is private (copy on write), so writing to a view never
reaches the file.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
          "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
          "I64": torch.int64, "BOOL": torch.bool}

# the format's own limit on the header (the safetensors package refuses
# longer ones)
MAX_HEADER = 100_000_000


class SafetensorsFile:
    """One ``.safetensors`` file, its header parsed and checked: every
    entry's dtype known, its byte range inside the data and as long as its
    shape needs, and no two ranges overlapping.  Raises ``ValueError`` on a
    malformed file."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: shorter than a safetensors "
                                 f"header")
            (n,) = struct.unpack("<Q", head)
            if n > min(MAX_HEADER, size - 8):
                raise ValueError(f"{path}: header length {n} does not fit "
                                 f"the file of {size} bytes")
            try:
                header = json.loads(f.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: header is not JSON: {e}") from e
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        meta = header.pop("__metadata__", None)
        if meta is not None and not (
                isinstance(meta, dict)
                and all(isinstance(v, str) for v in meta.values())):
            raise ValueError(f"{path}: __metadata__ must map names to "
                             f"strings")
        self.metadata: Optional[Dict[str, str]] = meta
        self._start = 8 + n
        self._entries: Dict[str, Tuple[torch.dtype, tuple, int, int]] = {}
        data_len = size - self._start
        for name, e in header.items():
            self._entries[name] = _check_entry(path, name, e, data_len)
        spans = sorted((b, end, name)
                       for name, (_, _, b, end) in self._entries.items())
        for (_, end0, a), (b1, _, b) in zip(spans, spans[1:]):
            if b1 < end0:
                raise ValueError(f"{path}: the bytes of {a!r} and {b!r} "
                                 f"overlap")

    def keys(self) -> list:
        """The tensors' names, sorted (as ``safe_open(...).keys()``)."""
        return sorted(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name``: a view of the mapping where its offset
        suits its dtype, else a copy of its bytes."""
        dtype, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        offset = self._start + begin
        count = (end - begin) // dtype.itemsize
        if offset % dtype.itemsize:
            flat = torch.frombuffer(bytearray(self._map[offset:
                                                        self._start + end]),
                                    dtype=dtype)
        else:
            flat = torch.frombuffer(self._map, dtype=dtype, count=count,
                                    offset=offset)
        return flat.reshape(shape)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for name in self.keys():
            yield name, self.get_tensor(name)


def _check_entry(path, name, e, data_len) -> tuple:
    if not isinstance(e, dict) or set(e) != {"dtype", "shape",
                                             "data_offsets"}:
        raise ValueError(f"{path}: entry {name!r} is not "
                         f"{{dtype, shape, data_offsets}}")
    if e["dtype"] not in DTYPES:
        raise ValueError(f"{path}: {name!r} has dtype {e['dtype']!r}, "
                         f"not one of {sorted(DTYPES)}")
    dtype = DTYPES[e["dtype"]]
    shape, offsets = e["shape"], e["data_offsets"]
    if not (isinstance(shape, list) and all(
            isinstance(d, int) and not isinstance(d, bool) and d >= 0
            for d in shape)):
        raise ValueError(f"{path}: {name!r} has shape {shape!r}")
    if not (isinstance(offsets, list) and len(offsets) == 2 and all(
            isinstance(o, int) and not isinstance(o, bool)
            for o in offsets)):
        raise ValueError(f"{path}: {name!r} has data_offsets {offsets!r}")
    begin, end = offsets
    numel = 1
    for d in shape:
        numel *= d
    if not 0 <= begin <= end <= data_len \
            or end - begin != numel * dtype.itemsize:
        raise ValueError(f"{path}: {name!r} of shape {shape} "
                         f"{e['dtype']} has bytes [{begin}, {end}) in a "
                         f"data section of {data_len}")
    return dtype, tuple(shape), begin, end

