"""Rate control (host): CRF/CQP plus reactive 1-pass VBR/CBR.

Reference behavior surface: rc_process.c (qindex selection per frame,
bits-per-frame targeting, buffer model) — Docs/Appendix-Rate-Control.md.
Round-1 scope: all-intra streams.  CRF maps qp -> qindex directly; VBR
and CBR run a leaky-bucket controller that adapts the next frame's
base_q_idx from the realized bitrate (TPL-driven boosts land with the
lookahead stage)."""
from __future__ import annotations

import dataclasses

import numpy as np


def qp_to_qindex(qp: int) -> int:
    return min(255, max(1, qp * 4))


@dataclasses.dataclass
class RateControlState:
    mode: int                 # 0 = CQP/CRF, 1 = VBR, 2 = CBR
    target_bits_per_frame: float
    qindex: int
    min_qindex: int = 4
    max_qindex: int = 255
    buffer_bits: float = 0.0   # accumulated (actual - target)
    # CBR reacts faster and bounds the buffer harder
    gain: float = 0.04
    onepass: object = None     # rc_onepass.OnePassRC for modes 1/2
    # capped CRF (reference max_bit_rate / capped_crf role): a virtual
    # buffer at the cap drives a non-negative qindex offset on top of
    # the CRF-planned qindex
    cap_bits_per_frame: float = 0.0
    cap_level: float = 0.0
    cap_offset: int = 0

    @classmethod
    def create(cls, cfg, fps: float):
        qindex = qp_to_qindex(cfg.qp)
        tbr = max(cfg.target_bit_rate, 1)
        mode = cfg.rate_control_mode
        rc = cls(mode=mode,
                 target_bits_per_frame=tbr / max(fps, 1e-6),
                 qindex=qindex,
                 min_qindex=max(4, cfg.min_qp_allowed * 4),
                 max_qindex=min(255, cfg.max_qp_allowed * 4),
                 gain=0.08 if mode == 2 else 0.03)
        if mode in (1, 2):
            from svt_av1_tpu_torch.pipeline.rc_onepass import OnePassRC
            rc.onepass = OnePassRC.create(cfg, fps, cfg.source_width,
                                          cfg.source_height)
        if mode == 0 and getattr(cfg, "max_bit_rate", 0) > 0:
            rc.cap_bits_per_frame = cfg.max_bit_rate / max(fps, 1e-6)
        return rc

    @property
    def capped_crf(self) -> bool:
        return self.mode == 0 and self.cap_bits_per_frame > 0

    def frame_qindex(self) -> int:
        return int(np.clip(self.qindex + self.cap_offset,
                           self.min_qindex, self.max_qindex))

    def pick_q(self, is_key: bool = False, layer: int = 0,
               frame_offset: int = 1) -> int:
        """Per-frame qindex: the reference regulate_q pipeline (target
        size -> active range -> bits-per-mb inversion) for 1-pass
        VBR/CBR; CQP/CRF and pass-2 keep their planned q."""
        if (self.mode == 0 or self.onepass is None
                or getattr(self, "two_pass_q", None) is not None):
            return self.frame_qindex()
        q = self.onepass.pick_q(is_key, layer, frame_offset)
        return int(np.clip(q, self.min_qindex, self.max_qindex))

    def feedback(self, frame_bits: int, qindex: int, is_key: bool,
                 layer: int = 0, showable: bool = True):
        """Post-encode update (RC_PACKETIZATION_FEEDBACK role)."""
        if self.capped_crf:
            # virtual buffer at the cap; drains at the cap rate, never
            # goes negative (undershoot is free under capped CRF)
            self.cap_level = max(
                0.0, self.cap_level + frame_bits
                - self.cap_bits_per_frame)
            over = self.cap_level / max(self.cap_bits_per_frame, 1.0)
            self.cap_offset = int(np.clip(12.0 * over, 0, 96))
        if self.mode == 0:
            return
        if getattr(self, "two_pass_q", None) is not None:
            return
        if self.onepass is not None:
            self.onepass.postencode(qindex, frame_bits, is_key, layer,
                                    showable)
            self.qindex = self.onepass.q_1_frame
            return
        self.update(frame_bits)

    def update(self, frame_bits: int):
        """Feedback after packetization (the reference's
        RC_PACKETIZATION_FEEDBACK_RESULT path)."""
        if self.mode == 0:
            return
        if getattr(self, "two_pass_q", None) is not None:
            return  # 2nd pass: per-frame q comes from the stats plan
        err = frame_bits - self.target_bits_per_frame
        self.buffer_bits += err
        # proportional on the frame error + integral on the buffer
        adj = (self.gain * err / max(self.target_bits_per_frame, 1.0)
               + 0.5 * self.gain * self.buffer_bits
               / max(self.target_bits_per_frame, 1.0))
        self.qindex = int(np.clip(self.qindex + 24 * np.tanh(adj),
                                  self.min_qindex, self.max_qindex))
        # CBR: clamp the buffer to one second of bits
        if self.mode == 2:
            cap = self.target_bits_per_frame * 30
            self.buffer_bits = float(np.clip(self.buffer_bits, -cap, cap))


# ---------------------------------------------------------------------------
# CRF qindex model (rc_process.c:781 crf_qindex_calc port)
# ---------------------------------------------------------------------------

# tpl_hl_islice_div_factor / tpl_hl_base_frame_div_factor
# (rc_process.c:47-48), indexed by hierarchical levels
ISLICE_DIV = (1, 2, 2, 1, 1, 0.7)
BASE_DIV = (1, 3, 3, 2, 1, 1)
# non_base_qindex_weight_{ref,wq} (rc_process.c:44-46)
NON_BASE_W_REF = (100, 100, 100, 100, 100, 100)
NON_BASE_W_WQ = (100, 100, 300, 100, 100, 100)


def qindex_from_qstep_ratio(leaf_qindex: int, qstep_ratio: float,
                            bd: int = 8) -> int:
    """svt_av1_get_q_index_from_qstep_ratio (rc_process.c:750-774):
    walk the dc quantizer table from leaf_qindex to the qindex whose
    step crosses leaf_step * ratio."""
    from svt_av1_tpu_torch.ops.quant import dc_q
    target = dc_q(leaf_qindex, bd=bd) * qstep_ratio
    q = leaf_qindex
    if qstep_ratio < 1.0:
        while q > 0 and dc_q(q, bd=bd) > target:
            q -= 1
    else:
        while q < 255 and dc_q(q, bd=bd) < target:
            q += 1
    return q


def crf_qindex_calc(cq: int, r0: float, layer: int, hier: int,
                    is_intra: bool, arf_q=None, ref_layer: int = 0,
                    is_leaf: bool = False, bd: int = 8):
    """CRF qindex per frame from TPL r0 (crf_qindex_calc,
    rc_process.c:781-897, qstep-ratio path).

    cq: the configured CRF qindex (active_worst).  Key and base-layer
    frames scale their quantizer step by sqrt(adjusted r0) * weight
    (0.75 intra / 0.9 base); non-base non-leaf frames interpolate
    between the base frame's ratio qindex (arf_q) and cq, one step per
    temporal-layer delta from their deepest reference; leaves code at
    cq.  Returns (qindex, arf_q_out)."""
    hl = min(hier, 5)
    if is_intra:
        r0a = r0 / ISLICE_DIV[hl] if ISLICE_DIV[hl] else r0
        qfr = qindex_from_qstep_ratio(cq, float(np.sqrt(r0a) * 0.75),
                                      bd)
        return int(np.clip(qfr, 1, cq)), qfr
    if layer == 0:
        r0a = r0 / BASE_DIV[hl]
        qfr = qindex_from_qstep_ratio(cq, float(np.sqrt(r0a) * 0.9),
                                      bd)
        return int(np.clip(qfr, 1, cq)), qfr
    arf = int(arf_q) if arf_q is not None else int(cq)
    if is_leaf:
        # INTER_NORMAL leaves: active_best = cq_level
        return int(np.clip(max(cq, arf), 1, 255)), arf
    w1 = NON_BASE_W_REF[hl]
    w2 = NON_BASE_W_WQ[hl]
    ab = arf
    for _ in range(max(1, layer - ref_layer)):
        ab = (w1 * ab + w2 * cq + (w1 + w2) // 2) // (w1 + w2)
    return int(np.clip(max(ab, arf), 1, cq)), arf


def kf_boost_qindex(cq: int, r0: float, frames_to_key: int = -1,
                    is_720p_or_less: bool = True, bd: int = 8) -> int:
    """Key-frame q without TPL-ratio path: kf_boost from r0
    (get_cqp_kf_boost_from_r0, rc_process.c:537) mapped through the
    boost->qdelta model (svt_av1_compute_qdelta via rate ratio)."""
    if frames_to_key == -1:
        factor = (10.0 + 4.0) / 2
    else:
        factor = float(np.clip(np.sqrt(frames_to_key), 4.0, 10.0))
    mult = 3 if is_720p_or_less else 4
    boost = mult * (75.0 + 17.0 * factor) / max(r0, 1e-6)
    # boost -> rate ratio -> qdelta (the reference routes this through
    # bits-per-mb; the dominant term is the rate ratio boost/100)
    ratio = min(max(boost / 100.0, 1.0), 25.0)
    return compute_qindex_by_rate_ratio(cq, ratio, True, bd)


# the reference floors the correction factor at 0.005 (rc_process.c
# MIN_BPB_FACTOR), tuned for real content at real resolutions; highly
# compressible content (or tiny frames) needs the model to project far
# fewer bits per MB than the floored model allows, which otherwise
# pins q conservative and locks the controller into undershoot — use a
# lower floor so regulate_q can track the full dynamic range
MIN_BPB_FACTOR = 0.0001
MAX_BPB_FACTOR = 50.0


def bits_per_mb(frame_type_key: bool, qindex: int,
                correction: float = 1.0, bd: int = 8,
                cbr: bool = False) -> float:
    """svt_av1_rc_bits_per_mb (rc_process.c:602): projected bits per
    16x16 block at qindex under the R = enum * corr / q model."""
    from svt_av1_tpu_torch.ops.quant import ac_q
    # svt_av1_convert_qindex_to_q: ac step / 4 (8-bit scale)
    q = ac_q(qindex, bd=bd) / (4.0 * (1 << (2 * (bd - 8))))
    if cbr:
        enumerator = 1500000 if frame_type_key else 1300000
    else:
        enumerator = 1400000 if frame_type_key else 1000000
    return enumerator * correction / max(q, 1e-6)


def find_qindex_by_rate(desired_bpm: float, frame_type_key: bool,
                        best_q: int = 1, worst_q: int = 255,
                        bd: int = 8, cbr: bool = False) -> int:
    """find_qindex_by_rate (rc_process.c:617): binary search the
    monotone bits-per-mb model."""
    lo, hi = best_q, worst_q
    while lo < hi:
        mid = (lo + hi) >> 1
        if bits_per_mb(frame_type_key, mid, 1.0, bd, cbr) > desired_bpm:
            lo = mid + 1
        else:
            hi = mid
    return lo


def compute_qindex_by_rate_ratio(qindex: int, rate_ratio: float,
                                 frame_type_key: bool,
                                 bd: int = 8) -> int:
    """svt_av1_compute_qdelta_by_rate (rc_process.c:640) applied:
    qindex whose projected rate is rate_ratio x the base qindex's."""
    base = bits_per_mb(frame_type_key, qindex, 1.0, bd)
    return find_qindex_by_rate(rate_ratio * base, frame_type_key,
                               1, 255, bd)


# ---------------------------------------------------------------------------
# 2-pass VBR (reference: firstpass.c stats + pass2_strategy.c allocation)
# ---------------------------------------------------------------------------

STATS_MAGIC = b"SVTTPU1P"


def pack_first_pass_stats(entries) -> bytes:
    """entries: list of (frame_bits, qindex, is_key).  The first-pass
    analog of FIRSTPASS_STATS (firstpass.h), serialized for
    rc_stats_buffer."""
    arr = np.array(entries, dtype=np.float64)
    return STATS_MAGIC + arr.tobytes()


def unpack_first_pass_stats(buf: bytes) -> np.ndarray:
    assert buf[:8] == STATS_MAGIC, "bad first-pass stats buffer"
    return np.frombuffer(buf[8:], dtype=np.float64).reshape(-1, 3)


def plan_second_pass(stats: np.ndarray, target_bit_rate: float,
                     fps: float, min_q: int = 4, max_q: int = 255
                     ) -> np.ndarray:
    """Per-frame qindex plan from first-pass complexity with two-level
    (sequence -> kf-group -> frame) bit allocation.

    Structure mirrors pass2_strategy.c: the sequence budget is split
    across keyframe groups in proportion to each group's first-pass
    complexity (get_kf_group_bits :719 role); within a group the key
    frame receives a boost share (kf boost role) and the remaining
    frames split the rest proportionally; targets invert through the
    R ~ 1/qstep model around the first-pass operating point."""
    from svt_av1_tpu_torch.ops.quant import ac_q
    n = len(stats)
    total_budget = target_bit_rate / max(fps, 1e-6) * n
    bits1 = np.maximum(stats[:, 0], 1.0)
    q1 = stats[:, 1].astype(np.int32)
    is_key = stats[:, 2] > 0.5 if stats.shape[1] > 2 \
        else np.zeros(n, bool)
    # keyframe-group boundaries (group 0 starts at frame 0 even if the
    # stats begin mid-stream)
    starts = [0] + [i for i in range(1, n) if is_key[i]]
    bounds = list(zip(starts, starts[1:] + [n]))
    # sequence -> group: proportional to flattened complexity share
    gshare = np.array([np.sum(bits1[a:b] ** 0.75) for a, b in bounds])
    gbits = total_budget * gshare / gshare.sum()
    KF_BOOST = 2.0   # key frames earn ~2x their proportional share
    target = np.zeros(n, np.float64)
    for (a, b), gb in zip(bounds, gbits):
        share = bits1[a:b] ** 0.75
        if is_key[a] or a == 0:
            share = share.copy()
            share[0] *= KF_BOOST
        target[a:b] = gb * share / share.sum()
    qsteps1 = np.array([ac_q(int(q), bd=8) for q in q1], np.float64)
    # R ~ c / qstep  =>  qstep2 = qstep1 * bits1 / target
    qstep2 = qsteps1 * bits1 / np.maximum(target, 1.0)
    # invert qstep -> qindex by table search
    table = np.array([ac_q(i, bd=8) for i in range(256)], np.float64)
    plan = np.searchsorted(table, qstep2).clip(min_q, max_q)
    return plan.astype(np.int32)
