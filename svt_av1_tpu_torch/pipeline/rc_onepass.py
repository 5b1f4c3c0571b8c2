"""One-pass CBR/VBR rate control (host control logic).

Behavioral reference: rc_process.c — av1_rc_regulate_q (:1931),
rate-correction factors (get/set :1785-1832, update :2259-2326),
active worst/best quality for no-stats CBR (:1978-2076), buffer model
(update_buffer_level :2328, set_rc_buffer_sizes :1627) — and
pass2_strategy.c:361-432 (per-frame target sizes).  The math is the
reference's R = enumerator * correction / q bits-per-mb model with
damped multiplicative feedback; the code is a fresh host-side
implementation (this layer is pure control logic feeding qindex to the
device programs, so there is nothing to map to the TPU).

Simplifications vs the reference, kept deliberately and documented:
- minq lookup tables (ASSIGN_MINQ_TABLE) are computed analytically with
  the same quadratic fits libaom generates them from (init_minq_luts),
  instead of carrying 256-entry baked tables.
- the CBR content-change q nudge that needs the average base-layer ME
  distortion (adjust_q_cbr :1893-1910) is omitted until the ME stage
  exports that statistic.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from svt_av1_tpu_torch.pipeline.rate_control import (
    MAX_BPB_FACTOR, MIN_BPB_FACTOR, bits_per_mb)

FRAME_OVERHEAD_BITS = 200

# rate-correction factor classes (rc_process.c rate_factor_level)
INTER_NORMAL = 0
GF_ARF_STD = 1
KF_STD = 2

# adjust_q_cbr max_delta_per_layer (rc_process.c:1891)
_MAX_DELTA = ((60,), (60, 5), (60, 5, 2), (60, 5, 2, 2),
              (60, 5, 2, 2, 2), (60, 5, 2, 2, 2, 2))


def _q_of(qindex: int, bd: int = 8) -> float:
    """svt_av1_convert_qindex_to_q: ac qstep on the 8-bit scale."""
    from svt_av1_tpu_torch.ops.quant import ac_q
    return ac_q(int(qindex), bd=bd) / (4.0 * (1 << (2 * (bd - 8))))


def _minq_curve(maxq_idx: int, x3: float, x2: float, x1: float,
                bd: int = 8) -> int:
    """Analytic minq lut entry (libaom init_minq_luts / get_minq_index):
    the qindex whose qstep reaches maxq * (x3*maxq^2 + x2*maxq + x1)."""
    maxq = _q_of(maxq_idx, bd)
    target = min(((x3 * maxq + x2) * maxq + x1) * maxq, maxq)
    for i in range(256):
        if _q_of(i, bd) >= target:
            return i
    return 255


def kf_minq(qindex: int, bd: int = 8) -> int:
    """KF active-best from the high-motion kf fit (the table
    get_kf_active_quality_tpl indexes)."""
    return _minq_curve(qindex, 0.0000021, -0.00125, 0.45, bd)


def rtc_minq(qindex: int, bd: int = 8) -> int:
    """Inter active-best fit (rtc_minq table)."""
    return _minq_curve(qindex, 0.00000271, -0.00113, 0.70, bd)


@dataclasses.dataclass
class OnePassRC:
    """Per-stream one-pass rate controller (CBR and reactive VBR)."""
    avg_frame_bandwidth: float    # target bits per frame
    mbs: int                      # 16x16 blocks per frame
    fps: float
    worst_q: int = 255
    best_q: int = 4
    bd: int = 8
    cbr: bool = True
    hier: int = 0                 # hierarchical levels (leaf = this layer)
    under_shoot_pct: int = 50
    over_shoot_pct: int = 25
    # buffer model (bits); reference defaults 600/600/1000 ms
    starting_buffer_level: float = 0.0
    optimal_buffer_level: float = 0.0
    maximum_buffer_size: float = 0.0
    # ---- state ----
    buffer_level: float = 0.0
    rcf: list = dataclasses.field(
        default_factory=lambda: [0.7, 0.7, 1.0])   # av1_rc_init:1669
    avg_q_key: float = 255.0
    avg_q_inter: float = 255.0
    q_1_frame: int = 255
    q_2_frame: int = 255
    rc_1_frame: int = 0
    rc_2_frame: int = 0
    frames_since_key: int = 0
    frames_updated: int = 0
    # per-rcf-class oscillation state:
    # {cls: (q_1, q_2, rc_1, rc_2, bits_1, bits_2)}
    # (libaom av1_rc_regulate_q resonance-guard role, applied within a
    # class because pyramid layers legitimately run different q; the
    # recovery step is a secant on the two observed (q, bits) outcomes
    # because the bits-vs-q curve is locally cliff-like — e.g. all-skip
    # above a threshold q — and the multiplicative rcf model rings
    # between the cliff edges)
    osc: dict = dataclasses.field(default_factory=dict)
    max_layer_seen: int = 0    # deepest layer observed (dynamic
                               # mini-GoP sizing can shrink the pyramid
                               # below cfg.hierarchical_levels)
    last_base_q: int = 255     # newest base-layer (arf-role) qindex
    last_q_layer: dict = dataclasses.field(default_factory=dict)
    vbr_bits_off: float = 0.0  # VBR cumulative (target - actual)

    @classmethod
    def create(cls, cfg, fps: float, width: int, height: int):
        bw = max(float(cfg.target_bit_rate), 1.0)
        worst = min(255, cfg.max_qp_allowed * 4)
        best = max(4, cfg.min_qp_allowed * 4)
        cbr = cfg.rate_control_mode == 2
        start = 0.600 * bw
        opt = 0.600 * bw
        mx = 1.000 * bw
        rc = cls(avg_frame_bandwidth=bw / max(fps, 1e-6),
                 mbs=((width + 15) // 16) * ((height + 15) // 16),
                 fps=fps, worst_q=worst, best_q=best,
                 bd=cfg.encoder_bit_depth, cbr=cbr,
                 hier=max(0, min(5, cfg.hierarchical_levels)),
                 under_shoot_pct=50 if cbr else 25,
                 starting_buffer_level=start,
                 optimal_buffer_level=opt, maximum_buffer_size=mx)
        rc.buffer_level = start
        rc.avg_q_key = rc.avg_q_inter = float(
            worst if cbr else (worst + best) // 2)
        rc.q_1_frame = rc.q_2_frame = worst
        rc.last_base_q = worst
        return rc

    # -- per-frame target size (pass2_strategy.c:375-432) -----------------
    def frame_target(self, is_key: bool, frame_offset: int = 1) -> float:
        if is_key:
            if frame_offset == 0:
                target = self.starting_buffer_level * 3 / 4
            else:
                kf_boost = max(32.0, 2 * self.fps - 16)
                if self.frames_since_key < self.fps / 2:
                    kf_boost *= self.frames_since_key / (self.fps / 2)
                target = (16 + kf_boost) * self.avg_frame_bandwidth / 16
            return min(target, self._max_frame_bandwidth())
        target = self.avg_frame_bandwidth
        if self.cbr:
            diff = self.optimal_buffer_level - self.buffer_level
            one_pct = 1.0 + self.optimal_buffer_level / 100.0
            if diff > 0:
                pct = min(diff / one_pct, self.under_shoot_pct)
                target -= target * pct / 200.0
            elif diff < 0:
                pct = min(-diff / one_pct, self.over_shoot_pct)
                target += target * pct / 200.0
        else:
            # reactive VBR: spend accumulated savings / recover debt
            # (the one-pass VBR role without first-pass stats).
            # Asymmetric on purpose: debt repays fast (over ~0.5 s,
            # down to a tenth of a frame's target) while savings are
            # spent slowly (+25% cap) — boosted frames already land on
            # the steep side of the bits-vs-q cliff, so handing them
            # big extra targets converts savings into overshoot debt
            # that the clip end never repays
            corr = self.vbr_bits_off / max(self.fps / 2, 1.0)
            target += float(np.clip(corr, -0.9 * target, 0.25 * target))
        return max(target,
                   max(self.avg_frame_bandwidth / 16,
                       FRAME_OVERHEAD_BITS))

    def _max_frame_bandwidth(self) -> float:
        return 8.0 * self.avg_frame_bandwidth * self.fps  # 8 sec cap

    # -- active quality range (rc_process.c:1978-2076) --------------------
    def active_worst(self, is_key: bool) -> int:
        if is_key:
            return self.worst_q
        ambient = (min(self.avg_q_inter, self.avg_q_key)
                   if self.frames_updated < 4 else self.avg_q_inter)
        if not self.cbr:
            # no-stats VBR (calc_active_worst_quality_no_stats_vbr):
            # ambient-anchored so the whole pyramid can descend when
            # content undershoots
            return int(np.clip(ambient * 5 / 4, self.best_q,
                               self.worst_q))
        aw = min(self.worst_q, ambient * 5 / 4)
        critical = self.optimal_buffer_level / 8
        if self.buffer_level > self.optimal_buffer_level:
            max_down = aw / 3
            if max_down:
                step = ((self.maximum_buffer_size
                         - self.optimal_buffer_level) / max_down)
                if step:
                    aw -= (self.buffer_level
                           - self.optimal_buffer_level) / step
        elif self.buffer_level > critical:
            step = self.optimal_buffer_level - critical
            if step:
                aw = ambient + ((self.worst_q - ambient)
                                * (self.optimal_buffer_level
                                   - self.buffer_level) / step)
        else:
            aw = self.worst_q
        return int(np.clip(aw, self.best_q, self.worst_q))

    def active_best(self, is_key: bool, layer: int, active_worst: int,
                    frame_offset: int = 1) -> int:
        if is_key:
            if frame_offset == 0:
                return self.best_q
            return max(self.best_q, kf_minq(int(self.avg_q_key),
                                            self.bd))
        # anchor on the reference picture's coded q (the next-lower
        # layer's most recent frame) and halve toward aw once per layer
        # step, as the reference does with its L0 ref
        # (calc_active_best_quality_no_stats_cbr: arf_q = ref qindex
        # - 28, tmp_layer_delta halvings)
        ref_layer = max(0, layer - 1)
        ref_q = self.last_q_layer.get(ref_layer, self.last_base_q)
        ab = rtc_minq(max(0, int(ref_q) - 28), self.bd)
        for _ in range(layer - ref_layer):
            ab = (ab + active_worst + 1) // 2
        return max(self.best_q, ab)

    # -- q selection (av1_rc_regulate_q :1931) -----------------------------
    def _rcf_class(self, is_key: bool, layer: int) -> int:
        if is_key:
            return KF_STD
        return GF_ARF_STD if layer == 0 else INTER_NORMAL

    def regulate_q(self, target_bits: float, is_key: bool, layer: int,
                   active_best: int, active_worst: int) -> int:
        corr = self.rcf[self._rcf_class(is_key, layer)]
        desired_bpm = target_bits / max(self.mbs, 1)

        def bpm(q):
            return bits_per_mb(is_key, q, corr, self.bd, self.cbr)

        lo, hi = active_best, max(active_best, active_worst)
        while lo < hi:
            mid = (lo + hi) >> 1
            if bpm(mid) > desired_bpm:
                lo = mid + 1
            else:
                hi = mid
        # closest-of-two (find_closest_qindex_by_rate)
        q = lo
        if q > active_best and bpm(q) <= desired_bpm:
            if (desired_bpm - bpm(q)) > (bpm(q - 1) - desired_bpm):
                q -= 1
        # resonance guard (libaom av1_rc_regulate_q role): when the
        # last two frames of this class alternated over/undershoot,
        # place q by a secant through their observed (q, bits) points
        # instead of the rcf model — the model rings on cliff-like
        # bits-vs-q curves
        # (VBR only: CBR has its own resonance control, the
        # max_delta_down clamp in _adjust_q_cbr)
        cls_ = self._rcf_class(is_key, layer)
        q1, q2, rc1, rc2, b1, b2 = self.osc.get(
            cls_, (0, 0, 0, 0, 0.0, 0.0))
        if (not self.cbr and not is_key and self.frames_since_key > 1
                and rc1 * rc2 == -1 and q1 != q2
                and b1 > 0 and b2 > 0 and target_bits > 0):
            (lo_q, lo_b), (hi_q, hi_b) = sorted(((q1, b1), (q2, b2)))
            if lo_b > hi_b > 0:   # bits must decrease in q to secant
                t = ((np.log(lo_b) - np.log(max(target_bits, 1.0)))
                     / (np.log(lo_b) - np.log(hi_b)))
                q = int(np.clip(round(lo_q + t * (hi_q - lo_q)),
                                lo_q, hi_q))
            else:
                q = int(np.clip(q, lo_q, hi_q))
        if self.cbr:
            q = self._adjust_q_cbr(q, is_key, layer)
        return int(np.clip(q, self.best_q, self.worst_q))

    def _adjust_q_cbr(self, q: int, is_key: bool, layer: int) -> int:
        # rc_process.c:1892 adjust_q_cbr — limit the decrease in q from
        # the previously coded frame (max_delta_per_layer, down-clamp of
        # q_1_frame/3)
        md = _MAX_DELTA[self.hier][min(layer, self.hier)]
        max_delta_down = min(md, max(1, self.q_1_frame // 3))
        if not is_key and self.frames_since_key > 1:
            if self.q_1_frame - q > max_delta_down:
                q = self.q_1_frame - max_delta_down
        return min(max(q, self.best_q), self.worst_q)

    def pick_q(self, is_key: bool, layer: int,
               frame_offset: int = 1) -> int:
        """target + active range + regulate in one call."""
        target = self.frame_target(is_key, frame_offset)
        aw = self.active_worst(is_key)
        ab = self.active_best(is_key, layer, aw, frame_offset)
        q = self.regulate_q(target, is_key, layer, ab, min(aw, 255))
        self._last_target = target
        return q

    # -- post-encode feedback (:2259-2346) ---------------------------------
    def postencode(self, qindex: int, frame_bits: float, is_key: bool,
                   layer: int, showable: bool = True):
        cls_ = self._rcf_class(is_key, layer)
        rcf = self.rcf[cls_]
        projected = max(FRAME_OVERHEAD_BITS,
                        bits_per_mb(is_key, qindex, rcf, self.bd,
                                    self.cbr) * self.mbs)
        correction = 100.0 * frame_bits / projected
        adjustment_limit = 0.25 + 0.5 * min(
            1.0, abs(np.log10(max(correction, 1e-6) / 100.0)))
        self.q_2_frame = self.q_1_frame
        self.q_1_frame = int(qindex)
        self.rc_2_frame = self.rc_1_frame
        self.rc_1_frame = (-1 if correction > 110
                           else 1 if correction < 90 else 0)
        q1, _q2, rc1, _rc2, b1, _b2 = self.osc.get(
            cls_, (0, 0, 0, 0, 0.0, 0.0))
        self.osc[cls_] = (int(qindex), q1, self.rc_1_frame, rc1,
                          float(frame_bits), b1)
        if correction > 102:
            correction = 100 + (correction - 100) * adjustment_limit
            rcf = min(rcf * correction / 100.0, MAX_BPB_FACTOR)
        elif correction < 99:
            correction = 100 - (100 - correction) * adjustment_limit
            rcf = max(rcf * correction / 100.0, MIN_BPB_FACTOR)
        self.rcf[cls_] = rcf

        self.max_layer_seen = max(self.max_layer_seen, layer)
        leaf_layer = min(self.hier, self.max_layer_seen)
        if is_key:
            self.avg_q_key = (3 * self.avg_q_key + qindex) / 4
            self.frames_since_key = 0
        elif self.hier == 0 or layer >= leaf_layer:
            # ambient tracks leaf / normal (LF_UPDATE) frames only —
            # GF/ARF/internal-ARF q's are boosted and excluded
            # (rc_process.c:2455-2461); leaf q rides active_worst, so
            # this is also what makes aw (and with it the whole
            # pyramid) descend under persistent undershoot
            self.avg_q_inter = (3 * self.avg_q_inter + qindex) / 4
        if layer == 0:
            self.last_base_q = int(qindex)
        if not is_key:
            self.last_q_layer[int(layer)] = int(qindex)
        self.frames_since_key += 1
        self.frames_updated += 1

        # buffer model (update_buffer_level :2328)
        if not showable:
            self.buffer_level -= frame_bits
        else:
            self.buffer_level += self.avg_frame_bandwidth - frame_bits
        self.buffer_level = min(self.buffer_level,
                                self.maximum_buffer_size)
        self.vbr_bits_off += self.avg_frame_bandwidth - frame_bits
