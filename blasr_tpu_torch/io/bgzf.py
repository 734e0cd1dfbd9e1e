# Copied from blasr_tpu/io/bgzf.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""BGZF (blocked gzip) reader/writer in pure Python + zlib.

The reference does BAM I/O through pbbam/htslib (Blasr.cpp:18-20,
configure.py:102-103); this image has neither pysam nor htslib, so the
container format is implemented directly: gzip members with a BC extra
subfield carrying the compressed block size, 64 KiB logical blocks, and
the 28-byte EOF sentinel block.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator

MAX_BLOCK = 65280  # uncompressed bytes per block (htslib convention)

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _block(data: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    bsize = len(payload) + 25 + 1  # header(12) + extra(6) + payload + crc/isize(8)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,      # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,            # mtime, xfl, os
        6,                     # xlen
        ord("B"), ord("C"), 2,  # BC subfield
        bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                         len(data) & 0xFFFFFFFF)
    return header + payload + footer


class BgzfWriter:
    def __init__(self, fileobj: BinaryIO):
        self.f = fileobj
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf.extend(data)
        while len(self.buf) >= MAX_BLOCK:
            self.f.write(_block(bytes(self.buf[:MAX_BLOCK])))
            del self.buf[:MAX_BLOCK]

    def flush(self) -> None:
        if self.buf:
            self.f.write(_block(bytes(self.buf)))
            self.buf.clear()

    def close(self) -> None:
        self.flush()
        self.f.write(_EOF_BLOCK)
        self.f.flush()


def iter_bgzf_blocks(f: BinaryIO) -> Iterator[bytes]:
    """Yield decompressed logical blocks from a BGZF (or plain gzip) file."""
    d = zlib.decompressobj(31)
    while True:
        chunk = f.read(65536)
        if not chunk:
            tail = d.flush()
            if tail:
                yield tail
            return
        data = d.decompress(chunk)
        if data:
            yield data
        while d.unused_data:
            rest = d.unused_data
            d = zlib.decompressobj(31)
            data = d.decompress(rest)
            if data:
                yield data


def read_bgzf(f: BinaryIO) -> bytes:
    return b"".join(iter_bgzf_blocks(f))
