"""Archive container (.fqz) — reader/writer.

Capability parity with the reference's ``SeqArcFile`` (SURVEY.md C11,
srcfile:SeqArcFile.cpp: writeFileInfo @0x4171b0 / readFileInfo @0x419660):
a magic + versioned header, a PARAM section carrying *all* coder parameters
(fixing the reference's unserialized-config pitfall, SURVEY.md §5), an
optional frozen-model blob, the original-file list, whole-input MD5s, and a
per-block table (compressed length, plaintext lengths, read count, flags,
block MD5) that makes every block independently seekable — the property the
block-data-parallel decode path relies on (SURVEY.md §2.3).

Layout:
    MAGIC "FQZTPU01"
    TLV PARAM      codec params (json)
    TLV FILELIST   original input file names ("\\n"-joined)
    TLV INPUT_MD5  16 bytes per input file
    TLV MODEL      optional frozen model blob (may be absent)
    TLV BLOCKTABLE packed per-block records
    TLV BLOCKS     concatenated block payloads (lengths in BLOCKTABLE)
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

from fastqueeze_tpu_torch.config import MAGIC, CodecParams
from fastqueeze_tpu_torch.container.encap import read_tlv, write_tlv, read_varint, write_varint

TAG_PARAM = 1
TAG_FILELIST = 2
TAG_INPUT_MD5 = 3
TAG_MODEL = 4
TAG_BLOCKTABLE = 5
TAG_BLOCKS = 6
TAG_PART = 7           # partial archive (--part K:N): struct "<II" (k, n)

FLAG_PE = 1
FLAG_ALIGNED = 2
FLAG_GZ_INPUT = 4


@dataclass
class BlockInfo:
    payload_len: int
    n_reads: int            # reads in file-1 for this block (== file-2 for PE)
    raw_len1: int           # plaintext bytes this block contributes to file 1
    raw_len2: int = 0       # ... to file 2 (PE only)
    flags: int = 0
    md5: bytes = b"\x00" * 16
    file_id: int = 0        # multi-file archives (-m): which input file

    _STRUCT = struct.Struct("<QQQQII16s")

    def pack(self) -> bytes:
        return self._STRUCT.pack(
            self.payload_len, self.n_reads, self.raw_len1, self.raw_len2,
            self.flags, self.file_id, self.md5)

    @classmethod
    def unpack(cls, raw: bytes, off: int) -> "BlockInfo":
        p, n, r1, r2, f, fid, m = cls._STRUCT.unpack_from(raw, off)
        return cls(p, n, r1, r2, f, m, fid)

    @classmethod
    def size(cls) -> int:
        return cls._STRUCT.size


class ArcWriter:
    """Collects out-of-order block payloads, writes the archive on close.

    The reference writes blocks to a temp file and merges (mergeFile
    @0x417790); here block payloads are spooled to a temp file as they
    arrive and concatenated in block order at finalize time.
    """

    def __init__(self, path: str, params: CodecParams,
                 file_list: List[str], input_md5s: List[bytes],
                 model_blob: Optional[bytes] = None,
                 part: Optional[tuple] = None):
        self.path = path
        self.params = params
        self.file_list = list(file_list)
        self.input_md5s = list(input_md5s)
        self.model_blob = model_blob
        self.part = part            # (k, n): this archive holds blocks k, k+n, ...
        self._spool = open(path + ".tmp", "w+b")
        self._spans: Dict[int, int] = {}      # block idx -> (offset in spool)
        self._infos: Dict[int, BlockInfo] = {}

    def add_block(self, idx: int, payload: bytes, info: BlockInfo) -> None:
        if idx in self._infos:
            raise ValueError(f"duplicate block {idx}")
        info.payload_len = len(payload)
        self._spans[idx] = self._spool.tell()
        self._spool.write(payload)
        self._infos[idx] = info

    def set_model(self, blob: bytes) -> None:
        self.model_blob = blob

    def finalize(self) -> None:
        n = len(self._infos)
        if self.part is not None:
            pk, pn = self.part
            order = [pk + j * pn for j in range(n)]
        else:
            order = list(range(n))
        if sorted(self._infos) != order:
            raise ValueError("missing blocks: " + repr(sorted(self._infos)[:8]))
        with open(self.path, "wb") as out:
            out.write(MAGIC)
            out.write(write_tlv(TAG_PARAM, self.params.to_bytes()))
            out.write(write_tlv(TAG_FILELIST,
                                "\n".join(self.file_list).encode()))
            out.write(write_tlv(TAG_INPUT_MD5, b"".join(self.input_md5s)))
            if self.part is not None:
                out.write(write_tlv(TAG_PART, struct.pack("<II", *self.part)))
            if self.model_blob is not None:
                out.write(write_tlv(TAG_MODEL, self.model_blob))
            table = b"".join(self._infos[i].pack() for i in order)
            out.write(write_tlv(TAG_BLOCKTABLE, table))
            total = sum(self._infos[i].payload_len for i in order)
            out.write(write_varint(TAG_BLOCKS))
            out.write(write_varint(total))
            for i in order:
                self._spool.seek(self._spans[i])
                out.write(self._spool.read(self._infos[i].payload_len))
        self._spool.close()
        import os
        os.unlink(self._spool.name)


class ArcReader:
    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        magic = self._fh.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path}: not a fastqueeze archive (bad magic {magic!r})")
        self.params: Optional[CodecParams] = None
        self.file_list: List[str] = []
        self.input_md5s: List[bytes] = []
        self.model_blob: Optional[bytes] = None
        self.blocks: List[BlockInfo] = []
        self.part: Optional[tuple] = None      # (k, n) for partial archives
        # header sections in file order, raw payload bytes — lets
        # merge_archives() reproduce the single-run header byte-for-byte
        self.raw_sections: List[tuple] = []
        self._block_offsets: List[int] = []
        self._read_header()

    def _read_header(self) -> None:
        fh = self._fh
        while True:
            tag = read_varint(fh)
            size = read_varint(fh)
            if tag == TAG_BLOCKS:
                base = fh.tell()
                off = base
                for bi in self.blocks:
                    self._block_offsets.append(off)
                    off += bi.payload_len
                if off - base != size:
                    raise ValueError("block table/section size mismatch")
                return
            payload = fh.read(size)
            if len(payload) != size:
                raise EOFError(f"truncated section tag {tag}")
            self.raw_sections.append((tag, payload))
            if tag == TAG_PARAM:
                self.params = CodecParams.from_bytes(payload)
            elif tag == TAG_PART:
                if len(payload) != 8:
                    raise ValueError("bad PART section")
                k, n = struct.unpack("<II", payload)
                if not (0 < n <= 1 << 20 and k < n):
                    raise ValueError(f"bad PART section ({k}, {n})")
                self.part = (k, n)
            elif tag == TAG_FILELIST:
                self.file_list = payload.decode().split("\n") if payload else []
            elif tag == TAG_INPUT_MD5:
                self.input_md5s = [payload[i:i + 16]
                                   for i in range(0, len(payload), 16)]
            elif tag == TAG_MODEL:
                self.model_blob = payload
            elif tag == TAG_BLOCKTABLE:
                step = BlockInfo.size()
                self.blocks = [BlockInfo.unpack(payload, o)
                               for o in range(0, len(payload), step)]
            # unknown tags are skipped (forward compatibility)

    def read_block(self, idx: int) -> bytes:
        info = self.blocks[idx]
        self._fh.seek(self._block_offsets[idx])
        return self._fh.read(info.payload_len)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
