"""Frame CDF state container.

Supports forward chaining (spec primary_ref_frame): a frame may start
from the end-of-frame CDF state saved with its primary reference instead
of the defaults — `clone()` snapshots the adapted state for the DPB.

Holds all adaptive CDF tables for one frame's entropy coding, initialized
from the normative AV1 defaults (codec/data/av1_default_cdfs.npz;
behavioral reference: cabac_context_model.c svt_av1_default_coef_probs /
init_mode_probs).  Coefficient CDFs are selected by the base qindex
context (get_q_ctx rule: <=20, <=60, <=120, else)."""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "av1_default_cdfs.npz")


@functools.lru_cache(maxsize=1)
def _defaults():
    return dict(np.load(_DATA))


def get_q_ctx(base_qindex: int) -> int:
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


class FrameCDFs:
    """Mutable per-frame CDF state (inverted-CDF convention, trailing
    counter slot).  Attribute names mirror FRAME_CONTEXT fields."""

    def __init__(self, base_qindex: int):
        d = _defaults()
        q = get_q_ctx(base_qindex)
        # mode / structure CDFs (qindex-independent defaults)
        self.partition = d["partition_cdf"].copy()
        self.kf_y_mode = d["kf_y_mode_cdf"].copy()
        self.y_mode = d["if_y_mode_cdf"].copy()
        self.uv_mode = d["uv_mode_cdf"].copy()
        self.angle_delta = d["angle_delta_cdf"].copy()
        self.intra_ext_tx = d["intra_ext_tx_cdf"].copy()
        self.inter_ext_tx = d["inter_ext_tx_cdf"].copy()
        self.skip = d["skip_cdfs"].copy()
        self.skip_mode = d["skip_mode_cdfs"].copy()
        self.tx_size = d["tx_size_cdf"].copy()
        self.txfm_partition = d["txfm_partition_cdf"].copy()
        self.filter_intra = d["filter_intra_cdfs"].copy()
        self.filter_intra_mode = d["filter_intra_mode_cdf"].copy()
        self.cfl_sign = d["cfl_sign_cdf"].copy()
        self.cfl_alpha = d["cfl_alpha_cdf"].copy()
        self.intrabc = d["intrabc_cdf"].copy()
        self.delta_q = d["delta_q_cdf"].copy()
        self.delta_lf = d["delta_lf_cdf"].copy()
        self.delta_lf_multi = d["delta_lf_multi_cdf"].copy()
        self.comp_inter = d["comp_inter_cdf"].copy()
        self.comp_ref_type = d["comp_ref_type_cdf"].copy()
        self.comp_ref = d["comp_ref_cdf"].copy()
        self.comp_bwdref = d["comp_bwdref_cdf"].copy()
        self.inter_compound_mode = d["inter_compound_mode_cdf"].copy()
        self.comp_group_idx = d["comp_group_idx_cdfs"].copy()
        self.compound_type = d["compound_type_cdf"].copy()
        self.wedge_idx = d["wedge_idx_cdf"].copy()
        self.obmc = d["obmc_cdf"].copy()
        self.interintra = d["interintra_cdf"].copy()
        self.interintra_mode = d["interintra_mode_cdf"].copy()
        self.wedge_interintra = d["wedge_interintra_cdf"].copy()
        self.seg_tree = d["seg_tree_cdf"].copy()
        self.segment_pred = d["segment_pred_cdf"].copy()
        self.spatial_pred_seg = d["spatial_pred_seg_tree_cdf"].copy()
        self.palette_y_size = d["palette_y_size_cdf"].copy()
        self.palette_uv_size = d["palette_uv_size_cdf"].copy()
        self.palette_y_mode = d["palette_y_mode_cdf"].copy()
        self.palette_uv_mode = d["palette_uv_mode_cdf"].copy()
        self.palette_y_color = d["palette_y_color_index_cdf"].copy()
        self.palette_uv_color = d["palette_uv_color_index_cdf"].copy()
        # inter CDFs (kept for parity; used once the inter path lands)
        self.intra_inter = d["intra_inter_cdf"].copy()
        self.switchable_interp = d["switchable_interp_cdf"].copy()
        self.newmv = d["newmv_cdf"].copy()
        self.zeromv = d["zeromv_cdf"].copy()
        self.refmv = d["refmv_cdf"].copy()
        self.drl = d["drl_cdf"].copy()
        self.single_ref = d["single_ref_cdf"].copy()
        self.switchable_restore = d["switchable_restore_cdf"].copy()
        self.wiener_restore = d["wiener_restore_cdf"].copy()
        self.sgrproj_restore = d["sgrproj_restore_cdf"].copy()
        # coefficient CDFs (qindex-dependent defaults)
        self.txb_skip = d["txb_skip_cdfs"][q].copy()
        self.eob_extra = d["eob_extra_cdfs"][q].copy()
        self.dc_sign = d["dc_sign_cdfs"][q].copy()
        self.eob_flag = {
            16: d["eob_multi16_cdfs"][q].copy(),
            32: d["eob_multi32_cdfs"][q].copy(),
            64: d["eob_multi64_cdfs"][q].copy(),
            128: d["eob_multi128_cdfs"][q].copy(),
            256: d["eob_multi256_cdfs"][q].copy(),
            512: d["eob_multi512_cdfs"][q].copy(),
            1024: d["eob_multi1024_cdfs"][q].copy(),
        }
        self.coeff_base = d["coeff_base_multi_cdfs"][q].copy()
        self.coeff_base_eob = d["coeff_base_eob_multi_cdfs"][q].copy()
        self.coeff_br = d["coeff_lps_multi_cdfs"][q].copy()

    def clone(self) -> "FrameCDFs":
        out = FrameCDFs.__new__(FrameCDFs)
        for k, v in self.__dict__.items():
            if isinstance(v, dict):
                setattr(out, k, {kk: vv.copy() for kk, vv in v.items()})
            else:
                setattr(out, k, v.copy())
        return out
