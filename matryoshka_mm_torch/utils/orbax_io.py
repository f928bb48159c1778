"""Reader and writer of orbax ``StandardCheckpointer`` directories, the
format the JAX package's ``utils/checkpoint.py`` saves, with no orbax,
tensorstore or zstandard (the card host has none of them).

A directory (``params/``, ``opt_state/``) holds:

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to its
  ``key_metadata`` (one ``{"key", "key_type"}`` per level: 1 a sequence,
  2 a dict) and its ``value_metadata`` (``value_type``: ``jax.Array``,
  ``np.ndarray``, ``scalar``, or an empty ``None`` / ``Dict`` / ``List`` /
  ``Tuple``);
* an OCDBT key-value store: ``manifest.ocdbt`` (the root, read as
  tensorstore opens the directory; a ``ocdbt.process_N/`` holds the
  store one process wrote, whose data files the root's b-tree names), and
  data files ``d/<name>`` holding b-tree nodes and values;
* in the store, one zarr v2 array a leaf: ``<a.b.c>/.zarray`` and chunks
  ``<a.b.c>/0.0`` (``0`` for a 0-d array), each a zstd frame.

OCDBT files start with a big-endian magic number, the file's length
(uint64 LE), a format version and a compression (varints; 1 = zstd), and
end with the CRC-32C of everything before it.  Manifests carry the store's
configuration, a data-file table and the newest versions (their root node
each); b-tree nodes carry a height, a data-file table and column-wise
entries: prefix-compressed keys, then inline values or (data file,
offset, length) references.

:func:`read_tree` gives the tree as nested dicts and lists of CPU torch
tensors (bf16 included: no numpy bfloat16 is needed), each moved to
``device`` as soon as it is read, or as :class:`LazyArray` leaves read on
demand.  :func:`write_tree` writes a single-process directory that
``ocp.StandardCheckpointer().restore(path)`` reads with no target: one
data file of values, one b-tree leaf node, zstd frames of raw blocks
(``native/zstd.cpp``; the port has no compressor, so its files are the
arrays' size: ``scripts/torch_orbax_size_cost.py`` compares them with
orbax's level-1 files).  Leaves are written as ``np.ndarray``: a
``jax.Array`` entry
needs a ``_sharding`` file naming a device, which a restore on another
host cannot find.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_ALL_ONES = (1 << 64) - 1
MAX_INLINE = 1024               # orbax's max_inline_value_bytes
MAX_NODE_BYTES = 100_000_000    # orbax's max_decoded_node_bytes

SEQUENCE, DICT = 1, 2

DTYPES = {"bfloat16": torch.bfloat16, "<f2": torch.float16,
          "<f4": torch.float32, "<f8": torch.float64, "|i1": torch.int8,
          "<i2": torch.int16, "<i4": torch.int32, "<i8": torch.int64,
          "|u1": torch.uint8, "|b1": torch.bool}
ZARR_DTYPE = {v: k for k, v in DTYPES.items()}


class FormatError(ValueError):
    """A file of the checkpoint is malformed, or uses something this
    reader does not know (named in the message)."""


# ---------------------------------------------------------------------------
# Byte-level helpers
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, data, what: str):
        self.b = memoryview(data)
        self.i = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise FormatError(f"{self.what}: truncated")

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.i += 1
        return self.b[self.i - 1]

    def fixed(self, n: int) -> bytes:
        self._need(n)
        self.i += n
        return bytes(self.b[self.i - n:self.i])

    def le(self, n: int) -> int:
        return int.from_bytes(self.fixed(n), "little")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _open_envelope(data: bytes, magic: int, what: str) -> bytes:
    """Check an OCDBT file's header and CRC-32C; its body, decoded."""
    if len(data) < 18:
        raise FormatError(f"{what}: truncated")
    if int.from_bytes(data[:4], "big") != magic:
        raise FormatError(f"{what}: bad magic number {data[:4].hex()}")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise FormatError(f"{what}: length field does not match the file")
    crc = int.from_bytes(data[-4:], "little")
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise FormatError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(memoryview(data)[:-4], what)
    cur.i = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise FormatError(f"{what}: unknown format version {version}")
    body = cur.b[cur.i:]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        return zstd.decompress(body)
    raise FormatError(f"{what}: unknown compression {compression}")


def _seal_envelope(body: bytes, magic: int) -> bytes:
    frame = zstd.raw_frame(body)
    head = magic.to_bytes(4, "big")
    tail = _varint(0) + _varint(1)       # version 0, zstd
    n = 4 + 8 + len(tail) + len(frame) + 4
    out = head + n.to_bytes(8, "little") + tail + frame
    return out + zstd.crc32c(out).to_bytes(4, "little")


def _read_data_files(cur: _Cursor) -> List[str]:
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    cur.varints(n)                       # base path lengths
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise FormatError(f"{cur.what}: data file prefix too long")
        prev = prev[:p] + cur.fixed(s)
        paths.append(prev.decode())
    return paths


def _write_data_files(paths: List[str]) -> bytes:
    out = _varint(len(paths))
    enc = [p.encode() for p in paths]
    out += b"".join(_varint(0) for _ in enc[1:])
    out += b"".join(_varint(len(p)) for p in enc)
    out += b"".join(_varint(0) for _ in enc)
    return out + b"".join(enc)


def _read_region(path: str, offset: int, length: int) -> np.ndarray:
    """``length`` bytes of ``path`` at ``offset``."""
    out = np.empty(length, np.uint8)
    with open(path, "rb", buffering=0) as f:
        f.seek(offset)
        view, got = memoryview(out), 0
        while got < length:
            n = f.readinto(view[got:])
            if not n:
                raise FormatError(f"{path}: truncated (wanted {length} bytes "
                                  f"at {offset})")
            got += n
    return out


# ---------------------------------------------------------------------------
# The OCDBT store
# ---------------------------------------------------------------------------

class OcdbtStore:
    """The newest version of the OCDBT store rooted at ``root``: every key
    with its value's place (inline bytes, or a data file's path, offset
    and length)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = _open_envelope(f.read(), MANIFEST_MAGIC, path)
        cur = _Cursor(body, path)
        cur.fixed(16)                    # uuid
        kind = cur.varint()
        if kind != 0:
            raise FormatError(f"{path}: numbered manifests are not "
                              f"supported (manifest kind {kind})")
        cur.varint()                     # max inline value bytes
        cur.varint()                     # max decoded node bytes
        cur.u8()                         # version tree arity (log2)
        if cur.varint() == 1:
            cur.le(4)                    # zstd level
        files = _read_data_files(cur)
        n = cur.varint()
        if n == 0:
            raise FormatError(f"{path}: no version in the manifest")
        gens = cur.varints(n)
        heights = [cur.u8() for _ in range(n)]
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        v = max(range(n), key=gens.__getitem__)
        self.generation = gens[v]
        self.entries: Dict[bytes, Any] = {}
        self._maps: Dict[str, Any] = {}
        if offsets[v] != _ALL_ONES:
            self._walk(self._file(files, ids[v], path), offsets[v],
                       lengths[v], heights[v], b"")

    def _file(self, files: List[str], i: int, what: str) -> str:
        if i >= len(files):
            raise FormatError(f"{what}: data file {i} out of range")
        return os.path.join(self.root, files[i])

    def _walk(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{path}@{offset}"
        body = _open_envelope(_read_region(path, offset, length).tobytes(),
                              NODE_MAGIC, what)
        cur = _Cursor(body, what)
        if cur.u8() != height:
            raise FormatError(f"{what}: node height does not match")
        files = _read_data_files(cur)
        n = cur.varint()
        pre = [0] + cur.varints(max(n - 1, 0))
        suf = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(pre, suf):
            if p > len(prev):
                raise FormatError(f"{what}: key prefix too long")
            prev = prev[:p] + cur.fixed(s)
            keys.append(prev)
        if height:
            ids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            for i, key in enumerate(keys):
                self._walk(self._file(files, ids[i], what), offs[i], lens[i],
                           height - 1, prefix + key[:common[i]])
            return
        lens = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            raise FormatError(f"{what}: unknown value kind")
        k_ind = sum(kinds)
        ids, offs = cur.varints(k_ind), cur.varints(k_ind)
        j = 0
        for key, ln, kind in zip(keys, lens, kinds):
            if kind:
                self.entries[prefix + key] = (
                    self._file(files, ids[j], what), offs[j], ln)
                j += 1
            else:
                self.entries[prefix + key] = cur.fixed(ln)

    def read(self, key: str):
        """A value's bytes, or None where the key is absent."""
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return _read_region(*v).tobytes()

    def view(self, key: str):
        """A value as a read-only uint8 view of its data file, mapped
        into memory (the pages are read as they are touched), or its
        inline bytes; None where the key is absent."""
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        path, offset, length = v
        m = self._maps.get(path)
        if m is None:
            with open(path, "rb") as f:
                m = self._maps[path] = mmap.mmap(f.fileno(), 0,
                                                 access=mmap.ACCESS_READ)
        if offset + length > len(m):
            raise FormatError(f"{path}: truncated (wanted {length} bytes at "
                              f"{offset})")
        return np.frombuffer(m, np.uint8, length, offset)

    def close(self) -> None:
        """Unmap the data files (the mappings also close when the store,
        and every lazy array of it, is dropped)."""
        for m in self._maps.values():
            m.close()
        self._maps.clear()

    def release(self, key: str) -> None:
        """Drop a mapped value's pages from this process (they stay in
        the page cache), so that a read holds one chunk's pages at a
        time."""
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes) or v[0] not in self._maps:
            return
        path, offset, length = v
        start = offset - offset % mmap.PAGESIZE
        if length:
            self._maps[path].madvise(mmap.MADV_DONTNEED, start,
                                     offset + length - start)


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[value]
    return value


class LazyArray:
    """One zarr v2 array of the store, read by :meth:`load`."""

    def __init__(self, store: OcdbtStore, name: str):
        self.store, self.name = store, name
        raw = store.read(f"{name}/.zarray")
        if raw is None:
            raise FormatError(f"no array {name!r} in {store.root}")
        meta = json.loads(raw)
        self.meta = meta
        if meta.get("zarr_format") != 2:
            raise FormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
        if meta["dtype"] not in DTYPES:
            raise FormatError(f"{name}: unknown dtype {meta['dtype']!r}")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise FormatError(f"{name}: unknown codec {comp.get('id')!r}")
        if meta.get("filters"):
            raise FormatError(f"{name}: unknown filters {meta['filters']!r}")
        if meta.get("order", "C") != "C":
            raise FormatError(f"{name}: order {meta['order']!r}")
        self.dtype = DTYPES[meta["dtype"]]
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        if len(self.chunks) != len(self.shape) or min(self.chunks,
                                                      default=1) < 1:
            raise FormatError(f"{name}: chunks {self.chunks} do not fit "
                              f"shape {self.shape}")
        self.sep = meta.get("dimension_separator", ".")

    def _chunk_key(self, idx) -> str:
        return f"{self.name}/" + (self.sep.join(map(str, idx)) or "0")

    def _decode(self, raw, out: torch.Tensor) -> None:
        """One chunk's stored bytes into ``out`` (a full chunk)."""
        flat = out.view(-1).view(torch.uint8) if out.dim() else \
            out.reshape(1).view(torch.uint8)
        if self.meta.get("compressor") is None:
            if len(raw) != flat.numel():
                raise FormatError(f"{self.name}: chunk holds {len(raw)} "
                                  f"bytes, expected {flat.numel()}")
            flat.numpy()[:] = np.frombuffer(raw, np.uint8)
            return
        n = zstd.decompress_into(raw, flat)
        if n != flat.numel():
            raise FormatError(f"{self.name}: chunk decoded to {n} bytes, "
                              f"expected {flat.numel()}")

    def load(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The array as a CPU tensor: a new one, or ``out`` (contiguous, of
        its shape and dtype, a pinned buffer for instance)."""
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype)
        elif tuple(out.shape) != self.shape or out.dtype != self.dtype \
                or not out.is_contiguous():
            raise ValueError(f"{self.name}: out is {tuple(out.shape)} "
                             f"{out.dtype}, expected {self.shape} {self.dtype}")
        if out.numel() == 0:
            return out
        whole = self.chunks == self.shape
        for idx in np.ndindex(*[-(-s // c) for s, c in zip(self.shape,
                                                           self.chunks)]):
            key = self._chunk_key(idx)
            raw = self.store.view(key)
            if whole:
                dst = out
            else:
                dst = torch.empty(self.chunks, dtype=self.dtype)
            if raw is None:
                dst.fill_(_fill(self.meta.get("fill_value")))
            else:
                self._decode(raw, dst)
                self.store.release(key)
            if not whole:
                region = tuple(slice(i * c, min((i + 1) * c, s))
                               for i, c, s in zip(idx, self.chunks,
                                                  self.shape))
                out[region] = dst[tuple(slice(0, r.stop - r.start)
                                        for r in region)]
        return out

    def __repr__(self) -> str:
        return f"LazyArray({self.name!r}, {self.shape}, {self.dtype})"


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": list}


def _assemble(items: List[Tuple[List[Tuple[str, int]], Any]], where: str):
    """Nested dicts / lists from ``(key_metadata, value)`` pairs."""
    def build(entries, depth, path):
        if len(entries) == 1 and len(entries[0][0]) == depth:
            return entries[0][1]
        kinds = {km[depth][1] for km, _ in entries if len(km) > depth}
        if len(kinds) != 1 or any(len(km) == depth for km, _ in entries):
            raise FormatError(f"{where}: inconsistent tree at {path}")
        kind = kinds.pop()
        if kind not in (SEQUENCE, DICT):
            raise FormatError(f"{where}: unknown key type {kind} at {path}")
        groups: Dict[str, list] = {}
        for km, v in entries:
            groups.setdefault(km[depth][0], []).append((km, v))
        children = {k: build(g, depth + 1, path + (k,))
                    for k, g in groups.items()}
        if kind == DICT:
            return children
        try:
            order = sorted(children, key=int)
        except ValueError:
            raise FormatError(f"{where}: non-integer sequence key at {path}")
        if [int(k) for k in order] != list(range(len(order))):
            raise FormatError(f"{where}: sequence at {path} has gaps")
        return [children[k] for k in order]

    if not items:
        return {}
    return build(items, 0, ())


def read_tree(path: str, device=None, lazy: bool = False):
    """The tree of an orbax ``StandardCheckpointer`` directory.  Array
    leaves are CPU tensors moved to ``device`` (if given) one at a time as
    they are read, or :class:`LazyArray` with ``lazy``; ``scalar`` leaves
    are Python numbers; empty ``None`` / ``Dict`` / ``List`` / ``Tuple``
    leaves are ``None`` / ``{}`` / ``[]``."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise FormatError(f"{path}: only OCDBT checkpoints are supported")
    if meta.get("use_zarr3", False):
        raise FormatError(f"{path}: zarr v3 arrays are not supported")
    store = OcdbtStore(path)
    items = []
    for entry in meta["tree_metadata"].values():
        km = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        vt = vm.get("value_type")
        name = ".".join(k for k, _ in km)
        if vm.get("skip_deserialize"):
            if vt not in _EMPTY:
                raise FormatError(f"{path}: leaf {name!r} has value type "
                                  f"{vt!r}, which is not supported")
            value = _EMPTY[vt]()
        elif vt in ("jax.Array", "np.ndarray", "scalar"):
            arr = LazyArray(store, name)
            if vt == "scalar":
                value = arr.load().item()
            elif lazy:
                value = arr
            else:
                value = arr.load()
                if device is not None:
                    value = value.to(device)
        else:
            raise FormatError(f"{path}: leaf {name!r} has value type "
                              f"{vt!r}, which is not supported")
        items.append((km, value))
    if not lazy:
        store.close()
    return _assemble(items, path)


def _flatten(tree, keys=()) -> List[Tuple[tuple, Any]]:
    """``(key path as (key, key_type) pairs, leaf)``, dict keys sorted."""
    if isinstance(tree, dict):
        if not tree:
            return [(keys, {})]
        return [x for k in sorted(tree, key=str)
                for x in _flatten(tree[k], keys + ((str(k), DICT),))]
    if isinstance(tree, (list, tuple)):
        if not tree:
            return [(keys, [])]
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, keys + ((str(i), SEQUENCE),))]
    return [(keys, tree)]


def _as_tensor(leaf) -> torch.Tensor:
    if callable(leaf) and not isinstance(leaf, torch.Tensor):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    a = np.ascontiguousarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _zarray(t: torch.Tensor) -> bytes:
    if t.dtype not in ZARR_DTYPE:
        raise TypeError(f"cannot store dtype {t.dtype} in a checkpoint")
    shape = list(t.shape)
    meta = {"chunks": [max(s, 1) for s in shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": ZARR_DTYPE[t.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":")).encode()


def _leaf_node(entries: List[Tuple[bytes, Any]], data_file: str) -> bytes:
    """One b-tree leaf node over sorted ``(key, value)``: a value is inline
    bytes or an ``(offset, length)`` in ``data_file``."""
    keys = [k for k, _ in entries]
    pre = []
    for a, b in zip(keys, keys[1:]):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        pre.append(n)
    suffixes = [keys[0]] + [k[p:] for k, p in zip(keys[1:], pre)]
    lens, kinds, offs, inline = [], [], [], []
    for _, v in entries:
        if isinstance(v, bytes):
            lens.append(len(v))
            kinds.append(0)
            inline.append(v)
        else:
            lens.append(v[1])
            kinds.append(1)
            offs.append(v[0])
    out = bytes([0]) + _write_data_files([data_file] if offs else [])
    out += _varint(len(entries))
    out += b"".join(map(_varint, pre))
    out += b"".join(_varint(len(s)) for s in suffixes) + b"".join(suffixes)
    out += b"".join(map(_varint, lens)) + b"".join(map(_varint, kinds))
    out += b"".join(_varint(0) for _ in offs) + b"".join(map(_varint, offs))
    return out + b"".join(inline)


def _manifest(data_file: str, node_off: int, node_len: int, n_keys: int,
              indirect: int) -> bytes:
    out = uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE)
    out += _varint(MAX_NODE_BYTES) + bytes([4])
    out += _varint(1) + (0).to_bytes(4, "little")       # zstd, level 0
    if n_keys:
        out += _write_data_files([data_file])
        out += _varint(1) + _varint(1) + bytes([0])     # one version, gen 1
        out += _varint(0) + _varint(node_off) + _varint(node_len)
    else:                                               # the empty tree
        out += _write_data_files([""])
        out += _varint(1) + _varint(1) + bytes([0])
        out += _varint(0) + _varint(_ALL_ONES) + _varint(_ALL_ONES)
    out += _varint(n_keys) + _varint(node_len) + _varint(indirect)
    out += time.time_ns().to_bytes(8, "little")
    return out + _varint(0)


def write_tree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays, Python numbers, None, or zero-argument callables giving a
    tensor, called one at a time) as an orbax ``StandardCheckpointer``
    directory at ``path``, replacing what is there."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(os.path.join(tmp, "d"))
    init_ns = time.time_ns()
    data_name = f"d/{uuid.uuid4().hex}"
    entries: List[Tuple[bytes, Any]] = []
    tree_meta = {}
    offset = indirect = 0
    frame_buf = None
    with open(os.path.join(tmp, data_name), "wb") as data:
        for keys, leaf in _flatten(tree):
            km = [{"key": k, "key_type": t} for k, t in keys]
            name = ".".join(k for k, _ in keys)
            if leaf is None or isinstance(leaf, (dict, list)):
                vt = {type(None): "None", dict: "Dict",
                      list: "List"}[type(leaf)]
                tree_meta[repr(tuple(k for k, _ in keys))] = {
                    "key_metadata": km,
                    "value_metadata": {"value_type": vt,
                                       "skip_deserialize": True}}
                continue
            scalar = isinstance(leaf, (bool, int, float))
            if scalar:
                t = torch.tensor(leaf, dtype=torch.bool if isinstance(
                    leaf, bool) else torch.int64 if isinstance(leaf, int)
                    else torch.float64)
            else:
                t = _as_tensor(leaf)
            tree_meta[repr(tuple(k for k, _ in keys))] = {
                "key_metadata": km,
                "value_metadata": {"value_type": "scalar" if scalar
                                   else "np.ndarray",
                                   "skip_deserialize": False}}
            entries.append((f"{name}/.zarray".encode(), _zarray(t)))
            if t.numel() == 0:
                continue
            src = t.reshape(-1).view(torch.uint8).numpy()
            size = zstd.raw_frame_size(src.size)
            if frame_buf is None or frame_buf.size < size:
                frame_buf = np.empty(size, np.uint8)
            zstd.raw_frame_into(src, frame_buf)
            frame = frame_buf[:size]
            key = f"{name}/{'.'.join('0' * t.dim()) or '0'}".encode()
            if size <= MAX_INLINE:
                entries.append((key, frame.tobytes()))
            else:
                data.write(memoryview(frame))
                entries.append((key, (offset, size)))
                offset += size
                indirect += size
            del t, src
        entries.sort(key=lambda e: e[0])
        node_len = 0
        if entries:
            node = _seal_envelope(_leaf_node(entries, data_name), NODE_MAGIC)
            data.write(node)
            node_len = len(node)
    with open(os.path.join(tmp, "manifest.ocdbt"), "wb") as f:
        f.write(_seal_envelope(_manifest(data_name, offset, node_len,
                                         len(entries), indirect),
                               MANIFEST_MAGIC))
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": init_ns,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
