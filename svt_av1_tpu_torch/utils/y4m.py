"""Y4M (YUV4MPEG2) reader/writer.

Capability parity with the reference CLI's Y4M input path
(reference Source/App/app_input_y4m.c: read_y4m_header / frame reads),
re-written for a numpy-based host pipeline.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Iterator, Optional, Tuple

import numpy as np

_COLORSPACE_INFO = {
    # name -> (subsampling_x, subsampling_y, bit_depth, monochrome)
    b"420": (1, 1, 8, False),
    b"420jpeg": (1, 1, 8, False),
    b"420mpeg2": (1, 1, 8, False),
    b"420paldv": (1, 1, 8, False),
    b"420p10": (1, 1, 10, False),
    b"420p12": (1, 1, 12, False),
    b"422": (1, 0, 8, False),
    b"422p10": (1, 0, 10, False),
    b"422p12": (1, 0, 12, False),
    b"444": (0, 0, 8, False),
    b"444p10": (0, 0, 10, False),
    b"444p12": (0, 0, 12, False),
    b"mono": (1, 1, 8, True),
}


@dataclasses.dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    interlace: str = "p"
    aspect_num: int = 0
    aspect_den: int = 0
    bit_depth: int = 8
    subsampling_x: int = 1  # 1 => chroma half-width (4:2:0 / 4:2:2)
    subsampling_y: int = 1  # 1 => chroma half-height (4:2:0)
    monochrome: bool = False

    @property
    def chroma_width(self) -> int:
        return 0 if self.monochrome else (self.width + self.subsampling_x) >> self.subsampling_x

    @property
    def chroma_height(self) -> int:
        return 0 if self.monochrome else (self.height + self.subsampling_y) >> self.subsampling_y

    @property
    def dtype(self):
        return np.uint8 if self.bit_depth == 8 else np.uint16

    @property
    def frame_size_bytes(self) -> int:
        bpp = 1 if self.bit_depth == 8 else 2
        luma = self.width * self.height
        chroma = 2 * self.chroma_width * self.chroma_height
        return (luma + chroma) * bpp


@dataclasses.dataclass
class Frame:
    """One planar video frame (host side)."""
    y: np.ndarray           # (h, w)
    u: Optional[np.ndarray]  # (ch, cw) or None for monochrome
    v: Optional[np.ndarray]
    bit_depth: int = 8
    subsampling_x: int = 1
    subsampling_y: int = 1


def parse_y4m_header(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a Y4M stream (missing YUV4MPEG2 magic)")
    hdr = Y4MHeader(width=0, height=0)
    for tok in line.split()[1:]:
        tag, val = tok[:1], tok[1:]
        if tag == b"W":
            hdr.width = int(val)
        elif tag == b"H":
            hdr.height = int(val)
        elif tag == b"F":
            num, den = val.split(b":")
            hdr.fps_num, hdr.fps_den = int(num), int(den)
        elif tag == b"I":
            hdr.interlace = val.decode()
        elif tag == b"A":
            num, den = val.split(b":")
            hdr.aspect_num, hdr.aspect_den = int(num), int(den)
        elif tag == b"C":
            key = val.lower()
            # strip e.g. "420mpeg2" suffixes we know, else exact match
            if key not in _COLORSPACE_INFO:
                raise ValueError(f"unsupported y4m colorspace {val!r}")
            sx, sy, bd, mono = _COLORSPACE_INFO[key]
            hdr.subsampling_x, hdr.subsampling_y = sx, sy
            hdr.bit_depth, hdr.monochrome = bd, mono
        # X comment tags ignored
    if hdr.width <= 0 or hdr.height <= 0:
        raise ValueError("y4m header missing W/H")
    return hdr


class Y4MReader:
    """Iterates frames of a .y4m file."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, (str, bytes)):
            self._f = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        line = self._f.readline()
        self.header = parse_y4m_header(line.rstrip(b"\n"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._own:
            self._f.close()

    def read_frame(self) -> Optional[Frame]:
        h = self.header
        line = self._f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad y4m FRAME marker: {line!r}")
        raw = self._f.read(h.frame_size_bytes)
        if len(raw) < h.frame_size_bytes:
            return None
        dt = h.dtype
        bpp = dt().itemsize
        yw, yh = h.width, h.height
        cw, ch = h.chroma_width, h.chroma_height
        off = 0
        y = np.frombuffer(raw, dt, yw * yh, off).reshape(yh, yw)
        off += yw * yh * bpp
        if h.monochrome:
            return Frame(y.copy(), None, None, h.bit_depth, h.subsampling_x, h.subsampling_y)
        u = np.frombuffer(raw, dt, cw * ch, off).reshape(ch, cw)
        off += cw * ch * bpp
        v = np.frombuffer(raw, dt, cw * ch, off).reshape(ch, cw)
        return Frame(y.copy(), u.copy(), v.copy(), h.bit_depth,
                     h.subsampling_x, h.subsampling_y)

    def __iter__(self) -> Iterator[Frame]:
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f


def write_y4m(path, frames, fps: Tuple[int, int] = (30, 1), bit_depth: int = 8):
    """Write frames (list of Frame or (y,u,v) tuples) to a 4:2:0 y4m file."""
    first = frames[0]
    y = first.y if isinstance(first, Frame) else first[0]
    h, w = y.shape
    cs = {8: b"420mpeg2", 10: b"C420p10", 12: b"C420p12"}[bit_depth]
    if bit_depth == 8:
        cs_tag = b"C420mpeg2"
    else:
        cs_tag = cs
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A0:0 %s\n"
                % (w, h, fps[0], fps[1], cs_tag))
        for fr in frames:
            if isinstance(fr, Frame):
                planes = (fr.y, fr.u, fr.v)
            else:
                planes = fr
            f.write(b"FRAME\n")
            for p in planes:
                if p is not None:
                    f.write(np.ascontiguousarray(p).tobytes())
