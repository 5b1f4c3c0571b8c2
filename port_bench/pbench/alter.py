"""Faults and the control, planted at the encoder's API boundary.

The benchmark's own runs never use this module.  The tests drive a whole
run through it to see ``correct`` come out false, and ``control.py`` reads
the compared numbers under each on the chip at a cell's own size.

- ``control_7bit``: the control, a whole encode one bit below the
  configuration's 8: every frame goes in with its lowest bit cleared, the
  source carried at 7 bits, and the stream and its reconstruction come
  out as the encoder makes them, consistent with each other.
- ``stale``: a step that returns its state unchanged: every packet of a
  call carries the first packet's bitstream and reconstruction.
- ``half``: half of each call's frames left out (every second frame of a
  frame-by-frame stream), the rest coded.
- ``token``: a byte of every packet's bitstream altered where it is made.
- ``answer``: one luma sample of every reconstruction altered.
"""
from __future__ import annotations

import dataclasses

FAULTS = ("control_7bit", "stale", "half", "token", "answer")


def _alter(pkt, fault: str, first):
    recon = pkt.recon
    if fault == "answer" and recon is not None:
        recon = {k: v.copy() for k, v in recon.items()}
        recon["y"][0, 0] ^= 1
    elif fault == "stale" and first is not None:
        return dataclasses.replace(pkt, data=first.data, recon=first.recon)
    data = pkt.data
    if fault == "token":
        i = len(data) // 2
        data = data[:i] + bytes([data[i] ^ 0x5A]) + data[i + 1:]
    return dataclasses.replace(pkt, data=data, recon=recon)


class Altered:
    """An Encoder with ``fault`` planted: the same calls, altered packets
    or frames."""

    def __init__(self, enc, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
        self.enc, self.fault = enc, fault
        self._n = 0
        self._first = None

    def send_pictures(self, frames, eos: bool = False):
        self._first = None
        if self.fault == "control_7bit":
            frames = [tuple(p & 0xFE for p in f) for f in frames]
        if self.fault == "half":
            frames = frames[:len(frames) // 2]
        self.enc.send_pictures(frames, eos=eos)

    def send_picture(self, y, u, v, eos: bool = False):
        self._first = None
        self._n += 1
        if self.fault == "half" and self._n % 2 == 0 and not eos:
            return
        if self.fault == "control_7bit":
            y, u, v = y & 0xFE, u & 0xFE, v & 0xFE
        self.enc.send_picture(y, u, v, eos=eos)

    def flush(self):
        self._first = None
        self.enc.flush()

    def get_packet(self):
        pkt = self.enc.get_packet()
        if pkt is None:
            return None
        out = _alter(pkt, self.fault, self._first)
        if self._first is None:
            self._first = pkt
        return out
