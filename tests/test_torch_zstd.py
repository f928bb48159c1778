"""PyTorch port: ``native/zstd.cpp``, the port's own zstd decoder (the
card host has no ``zstandard``), held against ``zstandard``.

Every corpus of ``tests/torch_orbax_fixture.py`` at levels 1, 3 and 19,
with and without checksum and content size, decodes to its bytes; a walk
over the block headers shows that the frames drive every block type, every
literals type (raw, RLE, Huffman with 1 and 4 streams, treeless) and every
sequence mode of each of the three tables (predefined, RLE, FSE, repeat).
Frames whose window is smaller than their content, concatenated and
skippable frames, the frames tensorstore writes in a zarr array, and the
committed fixture frames (by SHA-256) decode too.  Truncated frames raise;
a corrupted frame raises or gives back exactly its content; a frame that
needs a dictionary raises.  The raw-block frames the writer makes are
valid zstd for ``zstandard``.
"""

import hashlib
import json

import numpy as np
import pytest
import torch
import zstandard

from matryoshka_mm_torch.native import zstd
from tests.torch_orbax_fixture import FIXTURE, corpora

CORPORA = corpora()


def _frame(data, level, checksum=False, size=True, **kw):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size,
                                    **kw).compress(data)


def _modes(frame: bytes) -> set:
    """The block, literals and sequence modes a frame uses (headers only)."""
    out, off = set(), 0
    while off < len(frame):
        magic = int.from_bytes(frame[off:off + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            out.add("skippable frame")
            off += 8 + int.from_bytes(frame[off + 4:off + 8], "little")
            continue
        fhd = frame[off + 4]
        single, flag = fhd >> 5 & 1, fhd >> 6
        fs = (1 if single else 0) if flag == 0 else 1 << flag
        p = off + 5 + (0 if single else 1) + [0, 1, 2, 4][fhd & 3] + fs
        while True:
            bh = int.from_bytes(frame[p:p + 3], "little")
            p += 3
            btype, bsize = bh >> 1 & 3, bh >> 3
            out.add(["raw block", "RLE block", "compressed block"][btype])
            if btype == 2:
                b = frame[p:p + bsize]
                lt, sf = b[0] & 3, b[0] >> 2 & 3
                out.add(["raw literals", "RLE literals", "Huffman literals",
                         "treeless literals"][lt])
                if lt < 2:
                    h = {0: 1, 1: 2, 2: 1, 3: 3}[sf]
                    v = int.from_bytes(b[:h], "little")
                    regen = v >> 3 if h == 1 else v >> 4
                    q = h + (regen if lt == 0 else 1)
                else:
                    out.add("1 stream" if sf == 0 else "4 streams")
                    h = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
                    v = int.from_bytes(b[:h], "little")
                    q = h + {3: v >> 14 & 0x3FF, 4: v >> 18 & 0x3FFF,
                             5: v >> 22 & 0x3FFFF}[h]
                n = b[q]
                nseq = n if n < 128 else (((n - 128) << 8) + b[q + 1]
                                          if n < 255 else 1)
                q += 1 if n < 128 else 2 if n < 255 else 3
                if nseq:
                    for name, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
                        out.add(f"{name} " + ["predefined", "RLE", "FSE",
                                              "repeat"][b[q] >> shift & 3])
            p += 1 if btype == 1 else bsize
            if bh & 1:
                break
        off = p + (4 if fhd >> 2 & 1 else 0)
    return out


ALL_MODES = {"raw block", "RLE block", "compressed block", "raw literals",
             "RLE literals", "Huffman literals", "treeless literals",
             "1 stream", "4 streams"} | {
    f"{t} {m}" for t in ("LL", "OF", "ML")
    for m in ("predefined", "RLE", "FSE", "repeat")}


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_decodes_what_zstandard_writes(name, level):
    data = CORPORA[name]
    for checksum in (False, True):
        for size in (False, True):
            frame = _frame(data, level, checksum, size)
            assert zstd.decompress(frame) == data
            assert zstd.content_size(frame) == (len(data) if size else -1)
    out = torch.empty(len(data), dtype=torch.uint8)
    assert zstd.decompress_into(_frame(data, level), out) == len(data)
    assert out.numpy().tobytes() == data


def test_the_corpora_drive_every_mode():
    seen = set()
    for data in CORPORA.values():
        for level in (1, 3, 19):
            seen |= _modes(_frame(data, level))
    assert ALL_MODES <= seen, sorted(ALL_MODES - seen)


def test_multi_block_frames_over_a_mebibyte():
    data = CORPORA["text"]
    assert len(data) > 1 << 20
    frame = _frame(data, 3, checksum=True)
    assert zstd.decompress(frame) == data
    # a window (1 KiB) far smaller than the content
    params = zstandard.ZstdCompressionParameters.from_level(
        3, window_log=10, write_checksum=1)
    small = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert zstd.decompress(small) == data


def test_concatenated_and_skippable_frames():
    a, b = CORPORA["small"], CORPORA["records"]
    skip = (0x184D2A5F).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"xyz"
    frames = skip + _frame(a, 1, size=False) + skip + _frame(b, 19, True)
    assert zstd.decompress(frames) == a + b
    assert zstd.decompress(skip + _frame(a, 3)) == a


def test_the_frames_tensorstore_writes_in_a_zarr_array(tmp_path):
    import tensorstore as ts

    x = np.random.default_rng(2).standard_normal((64, 300)).astype(np.float32)
    store = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/a",
                     "metadata": {"compressor": {"id": "zstd", "level": 1},
                                  "chunks": [32, 300], "dtype": "<f4",
                                  "shape": [64, 300]},
                     "create": True}).result()
    store.write(x).result()
    for i in (0, 1):
        raw = (tmp_path / "a" / f"{i}.0").read_bytes()
        assert raw[:4] == zstd.MAGIC
        got = np.frombuffer(zstd.decompress(raw), np.float32)
        np.testing.assert_array_equal(got.reshape(32, 300),
                                      x[32 * i:32 * (i + 1)])


def test_the_committed_frames():
    table = json.loads((FIXTURE / "frames.json").read_text())
    seen = set()
    for name, entry in table.items():
        frame = (FIXTURE / "frames" / f"{name}.zst").read_bytes()
        data = zstd.decompress(frame)
        assert len(data) == entry["size"]
        assert hashlib.sha256(data).hexdigest() == entry["sha256"], name
        seen |= _modes(frame)
    assert ALL_MODES <= seen, sorted(ALL_MODES - seen)


@pytest.mark.parametrize("name", ["words", "fp16", "zeros", "records"])
def test_truncated_frames_raise(name):
    data = CORPORA[name]
    for size in (False, True):
        frame = _frame(data, 19 if name == "words" else 3, size=size)
        for cut in sorted({1, 4, 5, 8, 12, len(frame) // 3,
                           len(frame) // 2, len(frame) - 3,
                           len(frame) - 1}):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut])


@pytest.mark.parametrize("name", ["words", "fp16", "ramp"])
def test_a_corrupted_frame_raises_or_gives_its_content(name):
    """With the content checksum on, a flipped byte anywhere either makes
    the decoder raise or leaves the output exactly right: never wrong
    bytes."""
    data = CORPORA[name]
    frame = bytearray(_frame(data, 3, checksum=True))
    rng = np.random.default_rng(4)
    raised = 0
    for pos in rng.integers(0, len(frame), 60):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = zstd.decompress(bytes(bad))
        except zstd.ZstdError:
            raised += 1
            continue
        assert out == data, pos
    assert raised >= 50


def test_refusals():
    data = CORPORA["words"][:50_000]
    d = zstandard.train_dictionary(
        2048, [data[i:i + 500] for i in range(0, 40_000, 500)])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(zstandard.ZstdCompressor(dict_data=d).compress(data))
    with pytest.raises(zstd.ZstdError, match="too small"):
        zstd.decompress_into(_frame(data, 1), bytearray(len(data) - 1))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"")


@pytest.mark.parametrize("n", [0, 1, 1000, 128 << 10, (128 << 10) + 1,
                               700_000])
def test_raw_block_frames_are_zstd(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    frame = zstd.raw_frame(data)
    assert len(frame) == zstd.raw_frame_size(n)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    assert _modes(frame) == {"raw block"}


def test_checksums():
    """CRC-32C's check value; a frame's XXH64 content checksum is held:
    altering any of its four bytes raises."""
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    data = CORPORA["small"] * 3
    frame = _frame(data, 1, checksum=True)
    assert zstd.decompress(frame) == data
    for i in range(1, 5):
        bad = bytearray(frame)
        bad[-i] ^= 0x40
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bytes(bad))
