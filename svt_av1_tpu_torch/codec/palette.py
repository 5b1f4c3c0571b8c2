"""Palette mode: normative syntax helpers (spec 5.11.46-49, 7.11.x).

Behavioral reference: palette.c (svt_get_palette_cache_y :153,
svt_av1_index_color_cache :106, svt_aom_get_palette_mode_ctx),
entropy_coding.c write_palette_colors_y / delta_encode_palette_colors /
pack_map_tokens (:4150-4290), cabac_context_model.c
svt_aom_get_palette_color_index_context_optimized (:2458-2560).

Shared by the tile encoder, tile decoder, and the MD rate model; the
color-index context derivation must be bit-identical on both sides.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

PALETTE_MIN_SIZE = 2
PALETTE_MAX_SIZE = 8
PALETTE_SIZES = 7
PALETTE_COLOR_INDEX_CONTEXTS = 5

# hash -> context (negative = unreachable)
_CTX_LOOKUP = [-1, -1, 0, -1, -1, 4, 3, 2, 1]


def bsize_ctx(bsize: int) -> int:
    from svt_av1_tpu_torch.codec import constants as cc
    npels = int(cc.block_size_wide[bsize]) * int(cc.block_size_high[bsize])
    return int(np.log2(npels)) - 6      # BLOCK_8X8 = 64 pels


def ceil_log2(n: int) -> int:
    if n < 2:
        return 0
    return int(np.ceil(np.log2(n)))


def write_uniform(enc, n: int, v: int) -> None:
    """aom write_uniform: near-uniform code for v in [0, n)."""
    l = n.bit_length() if n > 0 else 0
    m = (1 << l) - n
    if l == 0:
        return
    if v < m:
        enc.encode_literal(v, l - 1)
    else:
        enc.encode_literal(m + ((v - m) >> 1), l - 1)
        enc.encode_literal((v - m) & 1, 1)


def read_uniform(dec, n: int) -> int:
    l = n.bit_length() if n > 0 else 0
    m = (1 << l) - n
    if l == 0:
        return 0
    v = dec.read_literal(l - 1)
    if v < m:
        return v
    return (v << 1) - m + dec.read_literal(1)


def uniform_bits(n: int, v: int) -> int:
    l = n.bit_length() if n > 0 else 0
    m = (1 << l) - n
    if l == 0:
        return 0
    return l - 1 if v < m else l


def merge_cache(above_colors, left_colors) -> List[int]:
    """svt_get_palette_cache_y merge: sorted above/left colors into a
    deduped sorted cache (adjacent-dup removal, exact C order)."""
    cache: List[int] = []

    def add(v):
        if cache and cache[-1] == v:
            return
        cache.append(int(v))

    a = [] if above_colors is None else list(above_colors)
    le = [] if left_colors is None else list(left_colors)
    ai = li = 0
    while ai < len(a) and li < len(le):
        va, vl = a[ai], le[li]
        if vl < va:
            add(vl)
            li += 1
        else:
            add(va)
            ai += 1
            if vl == va:
                li += 1
    while ai < len(a):
        add(a[ai])
        ai += 1
    while li < len(le):
        add(le[li])
        li += 1
    return cache


def index_color_cache(cache: List[int], colors) -> Tuple[List[int],
                                                         List[int]]:
    """(cache_found flags per cache entry, out-of-cache colors)."""
    colors = [int(c) for c in colors]
    if not cache:
        return [], colors
    found = [0] * len(cache)
    in_cache = [0] * len(colors)
    n_in = 0
    for i, cv in enumerate(cache):
        if n_in >= len(colors):
            break
        for j, c in enumerate(colors):
            if c == cv and not in_cache[j]:
                # C impl breaks on the FIRST equal color (duplicates
                # cannot occur in a legal palette)
                in_cache[j] = 1
                found[i] = 1
                n_in += 1
                break
    out = [c for j, c in enumerate(colors) if not in_cache[j]]
    return found, out


def delta_encode_colors(enc, colors: List[int], bit_depth: int,
                        min_val: int = 1) -> None:
    """delta_encode_palette_colors (entropy_coding.c:4152-4196)."""
    num = len(colors)
    if num <= 0:
        return
    enc.encode_literal(colors[0], bit_depth)
    if num == 1:
        return
    deltas = [colors[i] - colors[i - 1] for i in range(1, num)]
    max_delta = max(deltas)
    min_bits = bit_depth - 3
    bits = max(ceil_log2(max_delta + 1 - min_val), min_bits)
    rng = (1 << bit_depth) - colors[0] - min_val
    enc.encode_literal(bits - min_bits, 2)
    for d in deltas:
        enc.encode_literal(d - min_val, bits)
        rng -= d
        bits = min(bits, ceil_log2(rng))


def delta_decode_colors(dec, num: int, bit_depth: int,
                        min_val: int = 1) -> List[int]:
    if num <= 0:
        return []
    colors = [dec.read_literal(bit_depth)]
    if num == 1:
        return colors
    min_bits = bit_depth - 3
    bits = min_bits + dec.read_literal(2)
    rng = (1 << bit_depth) - colors[0] - min_val
    for _ in range(num - 1):
        d = dec.read_literal(bits) + min_val
        colors.append(colors[-1] + d)
        rng -= d
        bits = min(bits, ceil_log2(rng))
    return colors


def color_bits_estimate(cache: List[int], colors, bit_depth: int) -> int:
    """Header bits of the color list (cache flags + delta coding)."""
    found, out = index_color_cache(cache, colors)
    bits = len(found)
    if out:
        bits += bit_depth
        if len(out) > 1:
            deltas = [out[i] - out[i - 1] for i in range(1, len(out))]
            b = max(ceil_log2(max(deltas) + 1 - 1), bit_depth - 3)
            bits += 2 + b * len(deltas)
    return bits


def color_index_ctx(color_map: np.ndarray, r: int, c: int
                    ) -> Tuple[int, int]:
    """(context, coded_index) for position (r, c) of the index map —
    the spec's neighbor-score hash plus the index reordering."""
    left = int(color_map[r, c - 1]) if c > 0 else -1
    top = int(color_map[r - 1, c]) if r > 0 else -1
    tl = int(color_map[r - 1, c - 1]) if (r > 0 and c > 0) else -1
    nbr = [left, top, tl]
    scores = [2, 2, 1]
    if nbr[0] == nbr[1]:
        scores[0] += scores[1]
        nbr[1] = -1
        if nbr[0] == nbr[2]:
            scores[0] += scores[2]
            nbr[2] = -1
    elif nbr[0] == nbr[2]:
        scores[0] += scores[2]
        nbr[2] = -1
    elif nbr[1] == nbr[2]:
        scores[1] += scores[2]
        nbr[2] = -1
    color_rank = []
    score_rank = []
    for i in range(3):
        if nbr[i] != -1:
            color_rank.append(nbr[i])
            score_rank.append(scores[i])
    while len(color_rank) < 3:
        color_rank.append(-1)
        score_rank.append(0)
    if score_rank[0] < score_rank[1] or \
            (score_rank[0] == score_rank[1]
             and color_rank[0] > color_rank[1]):
        score_rank[0], score_rank[1] = score_rank[1], score_rank[0]
        color_rank[0], color_rank[1] = color_rank[1], color_rank[0]
    if score_rank[0] < score_rank[2]:
        score_rank[0], score_rank[2] = score_rank[2], score_rank[0]
        color_rank[0], color_rank[2] = color_rank[2], color_rank[0]
    if score_rank[1] < score_rank[2]:
        score_rank[1], score_rank[2] = score_rank[2], score_rank[1]
        color_rank[1], color_rank[2] = color_rank[2], color_rank[1]
    cur = int(color_map[r, c])
    coded = cur
    same = -1
    for i in range(3):
        if color_rank[i] > cur:
            coded += 1
        elif color_rank[i] == cur:
            same = i
    if same != -1:
        coded = same
    h = (score_rank[0] * 1 + score_rank[1] * 2 + score_rank[2] * 2)
    ctx = _CTX_LOOKUP[h]
    assert ctx >= 0
    return ctx, coded


def inv_color_index(color_map: np.ndarray, r: int, c: int,
                    coded: int) -> int:
    """Decoder side: recover the true index from the coded (reordered)
    symbol given the already-decoded neighbor map."""
    left = int(color_map[r, c - 1]) if c > 0 else -1
    top = int(color_map[r - 1, c]) if r > 0 else -1
    tl = int(color_map[r - 1, c - 1]) if (r > 0 and c > 0) else -1
    nbr = [left, top, tl]
    scores = [2, 2, 1]
    if nbr[0] == nbr[1]:
        scores[0] += scores[1]
        nbr[1] = -1
        if nbr[0] == nbr[2]:
            scores[0] += scores[2]
            nbr[2] = -1
    elif nbr[0] == nbr[2]:
        scores[0] += scores[2]
        nbr[2] = -1
    elif nbr[1] == nbr[2]:
        scores[1] += scores[2]
        nbr[2] = -1
    color_rank = []
    score_rank = []
    for i in range(3):
        if nbr[i] != -1:
            color_rank.append(nbr[i])
            score_rank.append(scores[i])
    while len(color_rank) < 3:
        color_rank.append(-1)
        score_rank.append(0)
    if score_rank[0] < score_rank[1] or \
            (score_rank[0] == score_rank[1]
             and color_rank[0] > color_rank[1]):
        score_rank[0], score_rank[1] = score_rank[1], score_rank[0]
        color_rank[0], color_rank[1] = color_rank[1], color_rank[0]
    if score_rank[0] < score_rank[2]:
        score_rank[0], score_rank[2] = score_rank[2], score_rank[0]
        color_rank[0], color_rank[2] = color_rank[2], color_rank[0]
    if score_rank[1] < score_rank[2]:
        score_rank[1], score_rank[2] = score_rank[2], score_rank[1]
        color_rank[1], color_rank[2] = color_rank[2], color_rank[1]
    # inverse of the reorder: coded < 3 and matching a valid rank slot
    # means "same as that neighbor"; otherwise undo the +1 shifts
    if coded < 3 and color_rank[coded] != -1:
        # candidate interpretation as "same neighbor" — but only when
        # the forward mapping would have produced it: the true index
        # then equals that neighbor's color
        cur = color_rank[coded]
        # verify forward: recompute coded from cur
        test = cur
        same = -1
        for i in range(3):
            if color_rank[i] > cur:
                test += 1
            elif color_rank[i] == cur:
                same = i
        if same != -1:
            test = same
        if test == coded:
            return cur
    # general inverse: find cur such that forward(cur) == coded
    for cur in range(PALETTE_MAX_SIZE):
        test = cur
        same = -1
        for i in range(3):
            if color_rank[i] > cur:
                test += 1
            elif color_rank[i] == cur:
                same = i
        if same != -1:
            test = same
        if test == coded:
            return cur
    raise AssertionError("no index maps to coded symbol")


def diagonal_scan(rows: int, cols: int):
    """Wavefront order of pack_map_tokens (k = r + c ascending, c
    descending within each anti-diagonal), skipping (0, 0)."""
    out = []
    for k in range(1, rows + cols - 1):
        for j in range(min(k, cols - 1), max(0, k - rows + 1) - 1, -1):
            out.append((k - j, j))
    return out


def map_bits_estimate(color_map: np.ndarray, n: int) -> float:
    """Index-map rate estimate under flat per-symbol cost (MD only)."""
    rows, cols = color_map.shape
    return uniform_bits(n, int(color_map[0, 0])) \
        + (rows * cols - 1) * max(1.0, np.log2(n) * 0.7)
