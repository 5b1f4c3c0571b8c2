"""Motion-vector entropy coding (AV1 spec §5.11.31 mv() / §8.3.2).

NMV default CDFs and the joint/class/offset decomposition; behavioral
reference: cabac_context_model.c:677 default_nmv_context and the
read_mv/encode_mv pair in md_rate_estimation.c / ec paths.

MVs and MV differences are (row, col) in 1/8-pel units.  Round-1
precision: allow_high_precision_mv = 0, force_integer_mv = 0, so
component differences must be 1/4-pel aligned (even in 1/8-pel units).
"""
from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch.codec.entropy import update_cdf

MV_JOINT_ZERO = 0
MV_JOINT_HNZVZ = 1   # col != 0, row == 0
MV_JOINT_HZVNZ = 2   # col == 0, row != 0
MV_JOINT_HNZVNZ = 3

MV_CLASSES = 11
CLASS0_SIZE = 2
CLASS0_BITS = 1
MV_OFFSET_BITS = 10
MV_MAX = (1 << 14) - 1  # component magnitude bound (spec 1/8 pel)

# precision levels
MV_SUBPEL_NONE = 0       # integer-pel (force_integer_mv)
MV_SUBPEL_LOW = 1        # 1/4 pel
MV_SUBPEL_HIGH = 2       # 1/8 pel (allow_high_precision_mv)


def _icdf(*probs) -> np.ndarray:
    """AOM_CDFn(a, b, ...) -> inverted-CDF row with counter slot."""
    vals = [32768 - p for p in probs] + [0, 0]
    return np.array(vals, dtype=np.uint16)


def _comp_cdfs() -> dict:
    return {
        "classes": _icdf(28672, 30976, 31858, 32320, 32551, 32656,
                         32740, 32757, 32762, 32767),
        "class0_fp": np.stack([_icdf(16384, 24576, 26624),
                               _icdf(12288, 21248, 24128)]),
        "fp": _icdf(8192, 17408, 21248),
        "sign": _icdf(128 * 128),
        "class0_hp": _icdf(160 * 128),
        "hp": _icdf(128 * 128),
        "class0": _icdf(216 * 128),
        "bits": np.stack([_icdf(128 * v) for v in
                          (136, 140, 148, 160, 176, 192, 224, 234,
                           234, 240)]),
    }


class NmvCDFs:
    """Adaptive NMV CDF state (joints + two identical components)."""

    def __init__(self):
        self.joints = _icdf(4096, 11264, 19328)
        self.comps = [_comp_cdfs(), _comp_cdfs()]

    def clone(self) -> "NmvCDFs":
        out = NmvCDFs.__new__(NmvCDFs)
        out.joints = self.joints.copy()
        out.comps = [{k: v.copy() for k, v in c.items()}
                     for c in self.comps]
        return out


def get_mv_class(z: int):
    """Class + in-class offset for magnitude-1 value z (z >= 0)."""
    if z >= CLASS0_SIZE * 4096:
        c = MV_CLASSES - 1
    else:
        k = z >> 3
        c = k.bit_length() - 1 if k >= 1 else 0
    base = (CLASS0_SIZE << (c + 2)) if c else 0
    return c, z - base


def mv_joint(diff) -> int:
    return (2 if diff[0] else 0) | (1 if diff[1] else 0)


def _encode_component(enc, cdfs: dict, comp: int, precision: int,
                      update: bool) -> None:
    sign = int(comp < 0)
    mag = -comp if sign else comp
    mv_class, offset = get_mv_class(mag - 1)
    d = offset >> 3
    fr = (offset >> 1) & 3
    hp = offset & 1
    enc.encode_symbol(sign, cdfs["sign"], 2)
    if update:
        update_cdf(cdfs["sign"], sign, 2)
    enc.encode_symbol(mv_class, cdfs["classes"], MV_CLASSES)
    if update:
        update_cdf(cdfs["classes"], mv_class, MV_CLASSES)
    if mv_class == 0:
        enc.encode_symbol(d, cdfs["class0"], 2)
        if update:
            update_cdf(cdfs["class0"], d, 2)
    else:
        n = mv_class + CLASS0_BITS - 1
        for i in range(n):
            b = (d >> i) & 1
            enc.encode_symbol(b, cdfs["bits"][i], 2)
            if update:
                update_cdf(cdfs["bits"][i], b, 2)
    if precision > MV_SUBPEL_NONE:
        fp_cdf = cdfs["class0_fp"][d] if mv_class == 0 else cdfs["fp"]
        enc.encode_symbol(fr, fp_cdf, 4)
        if update:
            update_cdf(fp_cdf, fr, 4)
        if precision > MV_SUBPEL_LOW:
            hp_cdf = cdfs["class0_hp"] if mv_class == 0 else cdfs["hp"]
            enc.encode_symbol(hp, hp_cdf, 2)
            if update:
                update_cdf(hp_cdf, hp, 2)


def _decode_component(dec, cdfs: dict, precision: int, update: bool) -> int:
    sign = dec.read_symbol(cdfs["sign"], 2)
    if update:
        update_cdf(cdfs["sign"], sign, 2)
    mv_class = dec.read_symbol(cdfs["classes"], MV_CLASSES)
    if update:
        update_cdf(cdfs["classes"], mv_class, MV_CLASSES)
    if mv_class == 0:
        d = dec.read_symbol(cdfs["class0"], 2)
        if update:
            update_cdf(cdfs["class0"], d, 2)
        mag0 = 0
    else:
        d = 0
        n = mv_class + CLASS0_BITS - 1
        for i in range(n):
            b = dec.read_symbol(cdfs["bits"][i], 2)
            if update:
                update_cdf(cdfs["bits"][i], b, 2)
            d |= b << i
        mag0 = CLASS0_SIZE << (mv_class + 2)
    if precision > MV_SUBPEL_NONE:
        fp_cdf = cdfs["class0_fp"][d] if mv_class == 0 else cdfs["fp"]
        fr = dec.read_symbol(fp_cdf, 4)
        if update:
            update_cdf(fp_cdf, fr, 4)
        if precision > MV_SUBPEL_LOW:
            hp_cdf = cdfs["class0_hp"] if mv_class == 0 else cdfs["hp"]
            hp = dec.read_symbol(hp_cdf, 2)
            if update:
                update_cdf(hp_cdf, hp, 2)
        else:
            hp = 1
    else:
        fr = 3
        hp = 1
    mag = mag0 + ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def encode_mv(enc, mv, ref_mv, nmv: NmvCDFs,
              precision: int = MV_SUBPEL_LOW, update: bool = True) -> None:
    """Encode mv - ref_mv; both are (row, col) in 1/8 pel."""
    diff = (mv[0] - ref_mv[0], mv[1] - ref_mv[1])
    j = mv_joint(diff)
    enc.encode_symbol(j, nmv.joints, 4)
    if update:
        update_cdf(nmv.joints, j, 4)
    if j & 2:  # row nonzero
        _encode_component(enc, nmv.comps[0], diff[0], precision, update)
    if j & 1:  # col nonzero
        _encode_component(enc, nmv.comps[1], diff[1], precision, update)


def decode_mv(dec, ref_mv, nmv: NmvCDFs,
              precision: int = MV_SUBPEL_LOW, update: bool = True):
    j = dec.read_symbol(nmv.joints, 4)
    if update:
        update_cdf(nmv.joints, j, 4)
    dr = _decode_component(dec, nmv.comps[0], precision, update) \
        if j & 2 else 0
    dc = _decode_component(dec, nmv.comps[1], precision, update) \
        if j & 1 else 0
    return (ref_mv[0] + dr, ref_mv[1] + dc)


def lower_mv_precision(mv, precision: int = MV_SUBPEL_LOW):
    """Round an MV to the coding precision (reference: lower_mv_precision).

    Low precision keeps 1/4 pel (clears bit 0 toward zero); integer
    precision keeps full pels (multiples of 8)."""
    out = []
    for v in mv:
        if precision == MV_SUBPEL_HIGH:
            out.append(v)
        elif precision == MV_SUBPEL_LOW:
            out.append(v - (1 if (v & 1) and v > 0 else 0)
                       + (1 if (v & 1) and v < 0 else 0))
        else:
            r = int(np.fmod(v, 8))  # C-style remainder (sign of v)
            v2 = v - r
            if abs(r) > 4:
                v2 += 8 if r > 0 else -8
            out.append(v2)
    return tuple(out)
