# Copied from blasr_tpu/io/bam.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""BAM reading/writing (pure Python codec over BGZF).

Capability parity with the reference's pbbam-backed BAM path
(``BamWriter``/``IRecordWriter``, Blasr.cpp:1300-1318; ``ReaderAgglomerate``
PBBAM input).  PacBio-specific conventions honored where cheap: qname
``movie/zmw/qstart_qend``, RG/np/qs/qe tags passed through when present.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from blasr_tpu_torch.io.bgzf import BgzfWriter, read_bgzf
from blasr_tpu_torch.io.fasta import FastaRecord, encode, revcomp

_CIGAR_OPS = "MIDNSHP=X"
# 4-bit seq nibbles: =ACMGRSVTWYHKDBN
_NIB_FOR_CODE = [1, 2, 4, 8, 15]  # A C G T N -> nibble
_CODE_FOR_NIB = np.full(16, 4, dtype=np.int8)
for _c, _n in ((0, 1), (1, 2), (2, 4), (3, 8)):
    _CODE_FOR_NIB[_n] = _c


@dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos: int              # 0-based
    mapq: int
    cigar: List[Tuple[str, int]]
    seq: np.ndarray       # codes 0..4 as stored (already strand-oriented)
    qual: Optional[np.ndarray]
    tags: Dict[str, object] = field(default_factory=dict)
    next_ref_id: int = -1  # RNEXT/PNEXT (subread-context threading)
    next_pos: int = -1


def _encode_tags(tags: Dict[str, object]) -> bytes:
    out = bytearray()
    for key, val in tags.items():
        k = key.encode()[:2]
        if isinstance(val, int):
            out += k + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += k + b"f" + struct.pack("<f", val)
        else:
            out += k + b"Z" + str(val).encode() + b"\0"
    return bytes(out)


def _decode_tags(buf: bytes) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    i = 0
    n = len(buf)
    sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}
    fmts = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H",
            b"i": "<i", b"I": "<I", b"f": "<f"}
    while i + 3 <= n:
        key = buf[i:i + 2].decode()
        typ = buf[i + 2:i + 3]
        i += 3
        if typ in fmts:
            tags[key] = struct.unpack_from(fmts[typ], buf, i)[0]
            i += sizes[typ]
        elif typ in (b"A",):
            tags[key] = chr(buf[i])
            i += 1
        elif typ in (b"Z", b"H"):
            end = buf.index(0, i)
            tags[key] = buf[i:end].decode()
            i = end + 1
        elif typ == b"B":
            sub = buf[i:i + 1]
            cnt = struct.unpack_from("<I", buf, i + 1)[0]
            width = sizes[sub]
            arr = [struct.unpack_from(fmts[sub], buf, i + 5 + j * width)[0]
                   for j in range(cnt)]
            tags[key] = arr
            i += 5 + cnt * width
        else:
            break
    return tags


class BamWriter:
    def __init__(self, fileobj: BinaryIO, header_text: str,
                 ref_names: List[str], ref_lengths: List[int]):
        self.w = BgzfWriter(fileobj)
        text = header_text.encode()
        buf = bytearray(b"BAM\x01")
        buf += struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(ref_names))
        for name, ln in zip(ref_names, ref_lengths):
            nb = name.encode() + b"\0"
            buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(ln))
        self.w.write(bytes(buf))

    @staticmethod
    def _reg2bin(beg: int, end: int) -> int:
        end -= 1
        if beg >> 14 == end >> 14:
            return ((1 << 15) - 1) // 7 + (beg >> 14)
        if beg >> 17 == end >> 17:
            return ((1 << 12) - 1) // 7 + (beg >> 17)
        if beg >> 20 == end >> 20:
            return ((1 << 9) - 1) // 7 + (beg >> 20)
        if beg >> 23 == end >> 23:
            return ((1 << 6) - 1) // 7 + (beg >> 23)
        if beg >> 26 == end >> 26:
            return ((1 << 3) - 1) // 7 + (beg >> 26)
        return 0

    def write_record(self, r: BamRecord) -> None:
        name = r.qname.encode() + b"\0"
        cigar = b"".join(
            struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op))
            for op, n in r.cigar)
        seq = np.asarray(r.seq, dtype=np.int8)
        l_seq = len(seq)
        nibs = np.array([_NIB_FOR_CODE[c] for c in seq], dtype=np.uint8)
        if l_seq % 2:
            nibs = np.concatenate([nibs, np.zeros(1, np.uint8)])
        packed = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
        if r.qual is not None:
            qual = bytes(int(min(q, 93)) for q in r.qual[:l_seq])
        else:
            qual = b"\xff" * l_seq
        tspan = sum(n for op, n in r.cigar if op in "MDN=X")
        rec = struct.pack(
            "<iiBBHHHiiii",
            r.ref_id, r.pos, len(name),
            r.mapq, self._reg2bin(r.pos, r.pos + max(tspan, 1)),
            len(r.cigar), r.flag, l_seq, r.next_ref_id, r.next_pos, 0,
        ) + name + cigar + packed + qual + _encode_tags(r.tags)
        self.w.write(struct.pack("<i", len(rec)) + rec)

    def close(self) -> None:
        self.w.close()


def read_bam(path: str) -> Tuple[str, List[str], List[int], List[BamRecord]]:
    with open(path, "rb") as f:
        data = read_bgzf(f)
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    text = data[off:off + l_text].decode(errors="replace")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names: List[str] = []
    lengths: List[int] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(data[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lengths.append(l_ref)
    records: List[BamRecord] = []
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, _nr, _np, _tl
         ) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_rn - 1].decode()
        p += l_rn
        cigar = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", data, p)
            cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
            p += 4
        nseq = (l_seq + 1) // 2
        packed = np.frombuffer(data[p:p + nseq], dtype=np.uint8)
        p += nseq
        nibs = np.empty(nseq * 2, dtype=np.uint8)
        nibs[0::2] = packed >> 4
        nibs[1::2] = packed & 0xF
        seq = _CODE_FOR_NIB[nibs[:l_seq]]
        qual_raw = data[p:p + l_seq]
        p += l_seq
        qual = None
        if l_seq and qual_raw[:1] != b"\xff":
            qual = np.frombuffer(qual_raw, dtype=np.uint8).astype(np.int32)
        tags = _decode_tags(data[p:end])
        records.append(BamRecord(qname, flag, ref_id, pos, mapq, cigar,
                                 seq, qual, tags))
        off = end
    return text, names, lengths, records


def read_bam_records(path: str) -> List[FastaRecord]:
    """Read a BAM as input reads (ReaderAgglomerate PBBAM path): unaligned
    or aligned records become read sequences in original orientation."""
    if path.lower().endswith(".sam"):
        return _read_sam_records(path)
    _, _, _, records = read_bam(path)
    out: List[FastaRecord] = []
    track_of_tag = {"iq": "InsertionQV", "dq": "DeletionQV",
                    "sq": "SubstitutionQV", "mq": "MergeQV"}
    for r in records:
        if r.flag & 0x900:  # secondary/supplementary: not a read
            continue
        seq = r.seq
        qual = r.qual
        rc = bool(r.flag & 16)
        if rc:
            seq = revcomp(seq)
            qual = qual[::-1] if qual is not None else None
        tracks = {}
        for tag, name in track_of_tag.items():
            v = r.tags.get(tag)
            if isinstance(v, str) and len(v) == len(seq):
                arr = (np.frombuffer(v.encode(), np.uint8).astype(np.int32)
                       - 33)
                tracks[name] = arr[::-1] if rc else arr
        out.append(FastaRecord(r.qname, seq, qual, tracks or None))
    return out


def _read_sam_records(path: str) -> List[FastaRecord]:
    out: List[FastaRecord] = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11 or fields[9] == "*":
                continue
            flag = int(fields[1])
            if flag & 0x900:
                continue
            seq = encode(fields[9])
            qual = None
            if fields[10] != "*":
                qual = (np.frombuffer(fields[10].encode(), np.uint8)
                        .astype(np.int32) - 33)
            if flag & 16:
                seq = revcomp(seq)
                qual = qual[::-1] if qual is not None else None
            out.append(FastaRecord(fields[0], seq, qual))
    return out
