"""IVF container writer/reader for AV1 bitstreams.

Parity with reference Source/App/app_output_ivf.c (32-byte IVF file header
+ 12-byte per-frame headers, fourcc AV01).
"""
from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

IVF_HDR = struct.Struct("<4sHH4sHHIIII")  # DKIF header
IVF_FRAME_HDR = struct.Struct("<IQ")


class IVFWriter:
    def __init__(self, path_or_file, width: int, height: int,
                 fps_num: int = 30, fps_den: int = 1, fourcc: bytes = b"AV01"):
        if isinstance(path_or_file, (str, bytes)):
            self._f = open(path_or_file, "wb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self._count_pos: Optional[int] = None
        self._count = 0
        hdr = IVF_HDR.pack(b"DKIF", 0, 32, fourcc, width, height,
                           fps_num, fps_den, 0, 0)
        self._f.write(hdr)

    def write_frame(self, data: bytes, pts: int):
        self._f.write(IVF_FRAME_HDR.pack(len(data), pts))
        self._f.write(data)
        self._count += 1

    def close(self):
        # patch frame count (byte offset 24)
        try:
            self._f.seek(24)
            self._f.write(struct.pack("<I", self._count))
        except (OSError, ValueError):
            pass  # non-seekable sink
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_ivf(path) -> Tuple[dict, List[Tuple[int, bytes]]]:
    """Returns (header dict, list of (pts, frame_bytes))."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, hdr_len, fourcc, w, h, fn, fd, count, _ = IVF_HDR.unpack_from(raw, 0)
    if magic != b"DKIF":
        raise ValueError("not an IVF file")
    frames = []
    off = hdr_len
    while off + 12 <= len(raw):
        size, pts = IVF_FRAME_HDR.unpack_from(raw, off)
        off += 12
        frames.append((pts, raw[off:off + size]))
        off += size
    header = dict(version=version, fourcc=fourcc, width=w, height=h,
                  fps_num=fn, fps_den=fd, frame_count=count)
    return header, frames
