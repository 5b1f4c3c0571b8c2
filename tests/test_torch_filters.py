"""The in-loop filters of the port (ops/dlf.py, ops/cdef.py,
pipeline/dlf_stage.py, pipeline/cdef_stage.py) vs the JAX package on the
same numpy inputs, on the CPU.  Every function here is integer and
normative (cdef_find_dir's float32 cost recombination included), so
every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clips
from svt_av1_tpu.codec import obu as jobu
from svt_av1_tpu.ops import cdef as jcdef
from svt_av1_tpu.ops import dlf as jdlf
from svt_av1_tpu.pipeline import cdef_stage as jcdef_stage
from svt_av1_tpu.pipeline import dlf_stage as jdlf_stage

from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.ops import cdef as tcdef
from svt_av1_tpu_torch.ops import dlf as tdlf
from svt_av1_tpu_torch.pipeline import cdef_stage, dlf_stage

torch.set_num_threads(2)

t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _edge_lines(rng, n):
    """(n, 14) int32 lines across an edge: a third smooth with a small step
    at the edge (the flat/wide paths), a third with a large step (high
    edge variance), a third rough."""
    base = rng.integers(20, 236, (n, 1))
    smooth = np.cumsum(rng.integers(-1, 2, (n, 14)), axis=1) // 2
    step = np.where(np.arange(14) >= 7, 1, 0)[None]
    kind = np.arange(n) % 3
    x = base + np.where(kind[:, None] == 0,
                        smooth + step * rng.integers(-6, 7, (n, 1)),
                        np.where(kind[:, None] == 1,
                                 smooth + step * rng.integers(-60, 61, (n, 1)),
                                 rng.integers(-25, 26, (n, 14))))
    return np.clip(x, 0, 255).astype(np.int32)


@pytest.mark.parametrize("level", [4, 12, 32, 63])
@pytest.mark.parametrize("flen", [4, 6, 8, 14])
def test_filter_lines_matches_jax(flen, level):
    rng = np.random.default_rng(flen * 100 + level)
    lines = _edge_lines(rng, 384)
    thr = tdlf.loop_filter_thresholds(level, 0)
    assert thr == jdlf.loop_filter_thresholds(level, 0)
    ref = np.asarray(jdlf.filter_lines(lines, *thr, flen))
    got = tdlf.filter_lines(t_(lines), *thr, flen).numpy()
    assert np.array_equal(got, ref)
    changed = got != lines
    assert changed.any(axis=1).sum() > 20
    if flen == 14 and level >= 12:       # the 13-tap path ran somewhere
        assert changed[:, 1].any() and changed[:, 12].any()


def _blocky(h, w, step, seed):
    """A smooth ramp with a per-block offset (coding blockiness), so the
    deblocker engages on most edges of the ``step`` grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    off = rng.integers(-4, 5, (h // step + 1, w // step + 1))
    x = 90 + xx // 3 + yy // 4 + off[yy // step, xx // step] \
        + rng.integers(0, 2, (h, w))
    return x.astype(np.int32)


@pytest.mark.parametrize("plane,step,flen,level", [
    ("luma", 16, 14, 20), ("chroma", 8, 6, 10)])
def test_loop_filter_plane_uniform_matches_jax(plane, step, flen, level):
    """64x96 luma; a 32x48 chroma plane, whose 14-wide gather windows,
    8 px apart, overlap (the port adds the deltas with index_add_)."""
    x = _blocky(64 if plane == "luma" else 32, 96 if plane == "luma" else 48,
                step, step)
    ref = np.asarray(jax.jit(jdlf.loop_filter_plane_uniform,
                             static_argnums=(1, 2, 3, 4))(
        jnp.asarray(x), step, level, 0, flen))
    xt = t_(x)
    got = tdlf.loop_filter_plane_uniform(xt, step, level, 0, flen)
    assert torch.equal(xt, t_(x))                   # input left as it was
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    # pixels on both sides of every vertical edge changed, q1 included
    # (q1 lies in the next window's span)
    for e in range(step, x.shape[1], step):
        assert (got.numpy()[:, e - 1] != x[:, e - 1]).any()
        assert (got.numpy()[:, e + 1] != x[:, e + 1]).any()
    assert tdlf.loop_filter_plane_uniform(xt, step, 0, 0, flen) is xt


def _cost_max(blocks):
    """Largest direction cost of each block, exact in int64."""
    x = blocks.reshape(len(blocks), 64).astype(np.int64) - 128
    part = np.einsum("dpi,bi->bdp", jcdef._partial_projections()
                     .astype(np.int64), x)
    return (part * part * jcdef._cost_weights().astype(np.int64)).sum(2) \
        .max(1)


def test_cdef_find_dir_matches_jax():
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 256, (300, 8, 8))
    # high-contrast blocks: stripes and checkers of 0/255 at every angle,
    # whose costs pass 2^24, where float32 rounds the recombined cost
    ii, jj = np.mgrid[0:8, 0:8]
    pats = [(ii + k * jj) // 2 % 2 for k in range(-3, 4)] \
        + [(jj + k * ii) // 2 % 2 for k in range(-3, 4)] + [(ii + jj) % 2]
    hi = np.stack([p * 255 for p in pats] + [(1 - p) * 255 for p in pats])
    noisy = np.clip(hi + rng.integers(-3, 4, hi.shape), 0, 255)
    blocks = np.concatenate([rand, hi, noisy]).astype(np.int32)
    assert (_cost_max(blocks) > 2 ** 24).sum() > 20
    d_ref, v_ref = jax.jit(jcdef.cdef_find_dir)(jnp.asarray(blocks))
    d_got, v_got = tcdef.cdef_find_dir(t_(blocks))
    assert d_got.dtype == v_got.dtype == torch.int32
    assert np.array_equal(d_got.numpy(), np.asarray(d_ref))
    assert np.array_equal(v_got.numpy(), np.asarray(v_ref))


# the JAX package's own test strength pairs (tests/test_cdef.py)
PAIRS = {8: [(4, 2), (9, 1), (0, 4), (12, 0), (19, 2)],
         4: [(4, 2), (7, 1), (0, 4), (2, 0)]}


@pytest.mark.parametrize("n", [8, 4])
def test_cdef_filter_block_matches_jax(n):
    """Every strength pair on one batch, at damping 3-6, with
    CDEF_VERY_LARGE rows and columns on a third of the windows."""
    rng = np.random.default_rng(n)
    nb = 48 * len(PAIRS[n])
    wins = rng.integers(0, 256, (nb, n + 4, n + 4)).astype(np.int32)
    wins[::3, :2] = tcdef.CDEF_VERY_LARGE
    wins[1::3, :, -2:] = tcdef.CDEF_VERY_LARGE
    pri, sec = (np.repeat(np.array(PAIRS[n], np.int32)[:, i], 48)
                for i in (0, 1))
    dirs = rng.integers(0, 8, nb).astype(np.int32)
    fn = jax.jit(lambda w, p, s, d, dp: jcdef.cdef_filter_block(
        w, p, s, d, dp, dp, n=n))
    for damping in (3, 4, 5, 6):
        ref = np.asarray(fn(wins, pri, sec, dirs, damping))
        got = tcdef.cdef_filter_block(t_(wins), t_(pri), t_(sec), t_(dirs),
                                      damping, damping, n=n)
        assert np.array_equal(got.numpy(), ref), damping
        assert (ref != wins[:, 2:2 + n, 2:2 + n]).any()


def _coded_frame():
    """A 64x64 source and a recon with coding blockiness: each 16x16 luma
    block (8x8 chroma) is its mean, the residual quantized in steps of 6,
    and a DC error of up to +-6."""
    y, u, v = clips.natural_clip(1, 64, 64, seed=3)[0]
    rng = np.random.default_rng(2)

    def code(p, b):
        x = p.astype(np.int32)
        h, w = x.shape
        up = lambda a: np.repeat(np.repeat(a, b, 0), b, 1)
        m = up(x.reshape(h // b, b, w // b, b).mean(axis=(1, 3)).round())
        dc = up(rng.integers(-6, 7, (h // b, w // b)))
        return np.clip(m + np.round((x - m) / 6.0) * 6 + dc, 0,
                       255).astype(np.uint8)
    return dict(y=y, u=u, v=v), dict(y=code(y, 16), u=code(u, 8),
                                     v=code(v, 8))


def test_dlf_search_and_apply_matches_jax():
    src, rec = _coded_frame()
    fp_j = jobu.FrameParams(base_q_idx=140)
    fp_t = obu.FrameParams(base_q_idx=140)
    ref = jdlf_stage.search_and_apply(src, rec, fp_j)
    got = dlf_stage.search_and_apply({k: t_(a) for k, a in src.items()},
                                     {k: t_(a) for k, a in rec.items()},
                                     fp_t)
    assert fp_t.filter_level == fp_j.filter_level
    assert fp_t.filter_level_uv == fp_j.filter_level_uv
    assert fp_t.filter_level[0] > 0
    assert min(fp_t.filter_level_uv) > 0
    for k in "yuv":
        assert got[k].dtype == torch.uint8
        assert np.array_equal(got[k].numpy(), ref[k]), k
    assert dlf_stage._ladder(6) == jdlf_stage._ladder(6)
    assert all(dlf_stage.default_filter_level(q)
               == jdlf_stage.default_filter_level(q) for q in range(256))


def test_cdef_search_and_apply_matches_jax():
    src, rec = _coded_frame()
    skip16 = np.random.default_rng(1).random((4, 4)) < 0.3
    assert skip16.any() and not skip16.all()
    ref_s = jcdef_stage.cdef_search(src, rec, skip16, 140)
    srct = {k: t_(a) for k, a in src.items()}
    rect = {k: t_(a) for k, a in rec.items()}
    got_s = cdef_stage.cdef_search(srct, rect, skip16, 140)
    assert got_s == ref_s and got_s != (0, 0, 0, 0)
    assert cdef_stage.SEARCH_SET == jcdef_stage.SEARCH_SET
    damping = cdef_stage.cdef_damping(140)
    ref = jcdef_stage.cdef_apply(rec, skip16, got_s, damping)
    got = cdef_stage.cdef_apply(rect, skip16, got_s, damping)
    for k in "yuv":
        assert got[k].dtype == torch.uint8
        assert np.array_equal(got[k].numpy(), ref[k]), k
        assert not np.array_equal(ref[k], rec[k]), k
    # skip 16x16 blocks keep their pixels
    keep = np.repeat(np.repeat(skip16, 16, 0), 16, 1)
    assert np.array_equal(got["y"].numpy()[keep], rec["y"][keep])
