"""AV1 spec enumerations and geometry constants.

These are normative spec enums (AV1 spec §3 / §6).  Reference decl parity:
Source/Lib/Codec/definitions.h (behavioral reference only).
"""
from __future__ import annotations

import numpy as np

# ---- Block sizes (BlockSizeS_ALL order) -----------------------------------
BLOCK_4X4 = 0
BLOCK_8X8 = 3
BLOCK_8X16 = 4
BLOCK_16X8 = 5
BLOCK_16X16 = 6
BLOCK_16X32 = 7
BLOCK_32X16 = 8
BLOCK_32X32 = 9
BLOCK_32X64 = 10
BLOCK_64X32 = 11
BLOCK_64X64 = 12

block_size_wide = np.array(
    [4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128,
     4, 16, 8, 32, 16, 64], dtype=np.int32)
block_size_high = np.array(
    [4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128,
     16, 4, 32, 8, 64, 16], dtype=np.int32)

# ---- Transform sizes (TX_SIZES_ALL order) ---------------------------------
TX_4X4 = 0
TX_8X8 = 1
TX_16X16 = 2
TX_32X32 = 3
TX_64X64 = 4
TX_4X8 = 5
TX_8X4 = 6
TX_8X16 = 7
TX_16X8 = 8
TX_16X32 = 9
TX_32X16 = 10
TX_32X64 = 11
TX_64X32 = 12
TX_16X64 = 17
TX_64X16 = 18

tx_size_wide = np.array(
    [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64],
    dtype=np.int32)
tx_size_high = np.array(
    [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16],
    dtype=np.int32)

# largest square tx size covering the rect tx (used for CDF context index)
tx_size_sqr = np.array(
    [0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2],
    dtype=np.int32)
tx_size_sqr_up = np.array(
    [0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4],
    dtype=np.int32)

# ---- Transform types -------------------------------------------------------
DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
FLIPADST_DCT = 4
DCT_FLIPADST = 5
FLIPADST_FLIPADST = 6
ADST_FLIPADST = 7
FLIPADST_ADST = 8
IDTX = 9
V_DCT = 10
H_DCT = 11
V_ADST = 12
H_ADST = 13
V_FLIPADST = 14
H_FLIPADST = 15

# 1-D transform kinds
TX1D_DCT = 0
TX1D_ADST = 1
TX1D_FLIPADST = 2
TX1D_IDTX = 3

# tx_type -> (vertical 1-D type, horizontal 1-D type); names are VERT_HORZ
tx_type_1d = {
    DCT_DCT: (TX1D_DCT, TX1D_DCT),
    ADST_DCT: (TX1D_ADST, TX1D_DCT),
    DCT_ADST: (TX1D_DCT, TX1D_ADST),
    ADST_ADST: (TX1D_ADST, TX1D_ADST),
    FLIPADST_DCT: (TX1D_FLIPADST, TX1D_DCT),
    DCT_FLIPADST: (TX1D_DCT, TX1D_FLIPADST),
    FLIPADST_FLIPADST: (TX1D_FLIPADST, TX1D_FLIPADST),
    ADST_FLIPADST: (TX1D_ADST, TX1D_FLIPADST),
    FLIPADST_ADST: (TX1D_FLIPADST, TX1D_ADST),
    IDTX: (TX1D_IDTX, TX1D_IDTX),
    V_DCT: (TX1D_DCT, TX1D_IDTX),
    H_DCT: (TX1D_IDTX, TX1D_DCT),
    V_ADST: (TX1D_ADST, TX1D_IDTX),
    H_ADST: (TX1D_IDTX, TX1D_ADST),
    V_FLIPADST: (TX1D_FLIPADST, TX1D_IDTX),
    H_FLIPADST: (TX1D_IDTX, TX1D_FLIPADST),
}

# ---- Intra prediction modes -------------------------------------------------
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12
INTRA_MODES = 13

# recursive filter-intra (spec 5.11.31): signaled as y_mode DC_PRED +
# use_filter_intra + filter_intra_mode.  MD uses pseudo-mode ids
# FI_MODE_BASE + k so filter candidates flow through the same wave RD.
FI_MODE_BASE = 64
FILTER_INTRA_MODES = 5
UV_CFL_PRED = 13
UV_INTRA_MODES = 14

# ---- Partition types (EXT_PARTITION_TYPES) ---------------------------------
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4
PARTITION_HORZ_B = 5
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9


