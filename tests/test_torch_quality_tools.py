"""The port's quality-preset (M0-M4) tools against the JAX package on the
CPU, exact:

- filter-intra (``filter_intra_pred`` / ``_multi``, spec 7.11.2.3) at
  every block size it is legal at (4..32), and D45 / D67 (zone 1) and
  D203 (zone 3) at every square size (4..64), on neighbours gathered from
  a reconstructed plane under each availability of the above / left /
  top-right / bottom-left edges;
- the wave step at 32x32 and 64x64 (the varpart program's, filter-intra
  candidates included, TX_64X64's coded 32x32 region) against the JAX
  step's stored outputs;
- per-SB CDEF: ``_sb_sse``, ``cdef_search_sb`` (bits, sets, index map)
  and ``cdef_apply(sb_idx=)``;
- ``gop_fast.run_key_filters(max_bits=3)`` (the GOP key frames' filter
  program at M0-M4) on a frame whose superblocks want different CDEF
  strengths, against the JAX program's stored outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_refs
from svt_av1_tpu.ops import intra as jintra
from svt_av1_tpu.pipeline import cdef_stage as jcdef
from svt_av1_tpu.pipeline import intra_encoder as jie
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.ops import intra, quant
from svt_av1_tpu_torch.pipeline import cdef_stage, gop_fast
from svt_av1_tpu_torch.pipeline import intra_encoder as tie

torch.set_num_threads(2)
CPU = torch.device("cpu")
# (have_above, have_left, top-right, bottom-left) per block of a batch:
# every combination
AVAIL = np.array([[(k >> i) & 1 for i in range(4)] for k in range(16)],
                 bool)


def _edges(n, seed):
    """Neighbours of 16 n x n blocks of a random reconstructed plane, one
    block per AVAIL row, gathered by both packages: (port (above, left,
    corner, above_ext, left_ext), JAX (the same))."""
    rng = np.random.default_rng(seed)
    side = 4 * n + 8
    plane = rng.integers(0, 256, (side, side)).astype(np.int32)
    ys = rng.integers(1, side - 2 * n, 16).astype(np.int32)
    xs = rng.integers(1, side - 2 * n, 16).astype(np.int32)
    ha, hl, tr, bl = (AVAIL[:, i] for i in range(4))
    t = lambda a: torch.as_tensor(a)
    fi = torch.zeros(16, dtype=torch.int64)
    port = tie._gather_neighbors(t(plane)[None], fi, t(ys).long(),
                                 t(xs).long(), n, t(ha), t(hl))
    port += tie._gather_ext_neighbors(t(plane)[None], fi, t(ys).long(),
                                      t(xs).long(), n, port[0], port[1],
                                      t(tr), t(bl))
    j = jie._gather_neighbors(jnp.asarray(plane), jnp.asarray(ys),
                              jnp.asarray(xs), n, jnp.asarray(ha),
                              jnp.asarray(hl))
    j += jie._gather_ext_neighbors(jnp.asarray(plane), jnp.asarray(ys),
                                   jnp.asarray(xs), n, j[0], j[1],
                                   jnp.asarray(tr), jnp.asarray(bl))
    for a, b in zip(port, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return port, j


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_filter_intra_matches_jax(n):
    """All five modes in one wavefront pass, and each alone, exact."""
    (a, l, c, _, _), (ja, jl, jc, _, _) = _edges(n, n)
    got = intra.filter_intra_pred_multi(a, l, c, tuple(range(5)), n, n)
    want = np.asarray(jintra.filter_intra_pred_multi(ja, jl, jc,
                                                     tuple(range(5)), n, n))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (0, 4):
        one = intra.filter_intra_pred(a, l, c, k, n, n)
        np.testing.assert_array_equal(
            one.numpy(), np.asarray(jintra.filter_intra_pred(ja, jl, jc, k,
                                                             n, n)))
    # the recursion reaches the far corner: it differs between modes
    assert len({got[k, 0, -1, -1].item() for k in range(5)}) > 1


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_d45_d67_d203_match_jax(n):
    """D45 / D67 through zone 1 and D203 through zone 3 on the extended
    edges, with and without the top-right / bottom-left samples, exact
    (the JAX predictors at the modes' angles)."""
    (a, l, c, ae, le), (_, _, _, jae, jle) = _edges(n, 100 + n)
    for mode in (cc.D45_PRED, cc.D67_PRED, cc.D203_PRED):
        got = intra.predict(mode, a, l, c, n, n, above_ext=ae, left_ext=le)
        angle = jintra.MODE_TO_ANGLE[mode]
        want = (jintra.z3_pred(jle, n, n, angle) if mode == cc.D203_PRED
                else jintra.z1_pred(jae, n, n, angle))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="extended edge"):
        intra.predict(cc.D45_PRED, a, l, c, n, n)


def _wave_inputs(n, seed=3):
    """A 2n x 4n recon plane with its top-left n x n blocks coded, the
    source, and three blocks of the second block row (left, middle, right
    edge of the plane) for one wave step."""
    rng = np.random.default_rng(seed)
    h, w = 2 * n, 4 * n
    yy, xx = np.mgrid[0:h, 0:w]
    src = np.clip(120 + 60 * np.sin(xx / 7.0 + yy / 11.0)
                  + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.int32)
    rec = np.zeros((h, w), np.int32)
    rec[:n] = np.clip(src[:n] + rng.integers(-3, 4, (n, w)), 0, 255)
    ys = np.full(3, n, np.int32)
    xs = np.array([0, n, 3 * n], np.int32)
    return src, rec, ys, xs


@pytest.mark.parametrize("n", [32, 64])
def test_wave_step_32_64_matches_jax(n):
    """One luma wave step at n = 32 (TX_32X32, the M2 modes with the five
    filter-intra candidates) and n = 64 (TX_64X64: filter-intra dropped,
    the projection's lost energy charged) with the analytic rate proxy,
    as the varpart program runs it, and the chroma step at n/2 (all-DCT
    at 32x32), against the JAX steps' stored outputs: modes, levels and
    reconstruction exact, the best cost within 1e-3 (float32 sums)."""
    src, rec, ys, xs = _wave_inputs(n)
    tx = cc.TX_32X32 if n == 32 else cc.TX_64X64
    modes = tie.ALL_MODES + tie.FI_MODES
    ha = np.ones(3, bool)
    hl = xs > 0
    tr = np.array([True, True, False])
    bl = np.zeros(3, bool)
    qidx = 120
    lam = tie.frame_lambda(qidx)
    cn = n // 2
    uv_tx = None if n == 32 else (cc.DCT_DCT,) * 4
    csrc = src[::2, ::2] // 2 + 40
    crec = rec[::2, ::2] // 2 + 40
    cx = cc.TX_16X16 if n == 32 else cc.TX_32X32

    def jax_step():
        from svt_av1_tpu.ops import quant as jq
        qp = tuple(jnp.asarray(a) for a in jq.make_quant_params(qidx))
        m, q, r, c = jie._rd_step(
            jnp.asarray(rec), jnp.asarray(src), jnp.asarray(ys),
            jnp.asarray(xs), jnp.ones(3, bool), jnp.asarray(ha),
            jnp.asarray(hl), qp, lam, n, tx, modes, 0,
            tr_avail=jnp.asarray(tr), bl_avail=jnp.asarray(bl),
            no_write=True)
        um, qu, qv, ru, rv = jie._rd_step_chroma(
            jnp.asarray(crec), jnp.asarray(crec), jnp.asarray(csrc),
            jnp.asarray(csrc), jnp.asarray(ys // 2), jnp.asarray(xs // 2),
            jnp.ones(3, bool), jnp.asarray(ha), jnp.asarray(hl), qp, lam,
            n=cn, tx_size=cx, no_write=True, uv_tx_types=uv_tx)
        return m, q, r, c, um, qu, qv, ru, rv

    want = port_refs.jax_ref(f"varpart_step_{n}", jax_step, src, rec, ys, xs)
    t = lambda a: torch.as_tensor(np.asarray(a))
    qp = quant.params_on(qidx, CPU)
    fi = torch.zeros(3, dtype=torch.int64)
    lam_t = torch.tensor(lam)
    m, q, r, c = tie._rd_step(
        t(rec)[None], t(src)[None], fi, t(ys).long(), t(xs).long(),
        torch.arange(3), t(ha), t(hl), qp, lam_t, modes, None,
        tr_avail=t(tr), bl_avail=t(bl), n=n, tx_size=tx, no_write=True)
    um, qu, qv, ru, rv = tie._rd_step_chroma(
        t(crec)[None], t(crec)[None], t(csrc)[None], t(csrc)[None], fi,
        t(ys // 2).long(), t(xs // 2).long(), torch.arange(3), t(ha), t(hl),
        qp, lam_t, None, n=cn, tx_size=cx, no_write=True,
        uv_tx_types=uv_tx or tie.UV_TX_TYPES)
    got = (m, q, r, c, um, qu, qv, ru, rv)
    assert q.shape[-1] == 32
    for i, (g, w_) in enumerate(zip(got, want)):
        if i == 3:
            # float32 costs: XLA's log2 approximation and torch's differ
            # in the last bits of the proxy (which lambda, ~250 here,
            # scales), and TX_64X64's projection charge subtracts two
            # float32 sums of ~1e7 taken in different orders
            np.testing.assert_allclose(g.numpy(), w_, rtol=1e-3)
        else:
            np.testing.assert_array_equal(g.numpy(), w_, err_msg=str(i))
    picked = [int(x) for x in m]
    print(f"n={n}: modes picked {picked}")
    if n == 64:
        assert all(p < cc.FI_MODE_BASE for p in picked)


def _cdef_frame(h=128, w=192, seed=5):
    """A source and a recon that differs from it by SB-dependent noise and
    blockiness, so that superblocks want different strengths; skip16
    marks the right SB column skipped."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    src = {"y": np.clip(110 + 50 * np.sin(xx / 9.0) + 40 * np.cos(yy / 7.0),
                        0, 255).astype(np.uint8)}
    for p in "uv":
        src[p] = np.clip(128 + 30 * np.sin(xx[::2, ::2] / 11.0), 0,
                         255).astype(np.uint8)
    rec = {}
    for p, s in src.items():
        amp = np.where((np.arange(s.shape[1]) // (64 if p == "y" else 32))
                       % 2 == 0, 12, 2)[None, :]
        noise = rng.integers(-1, 2, s.shape) * amp
        rec[p] = np.clip(s.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    skip16 = np.zeros((h // 16, w // 16), bool)
    skip16[:, -4:] = True
    return src, rec, skip16


def test_cdef_per_sb_matches_jax():
    """_sb_sse per candidate, cdef_search_sb (cdef_bits, the strength
    subset, the per-SB index map) and the per-SB apply, exact; the frame
    picks cdef_bits > 0."""
    src, rec, skip16 = _cdef_frame()
    t = {k: torch.as_tensor(v) for k, v in rec.items()}
    ts = {k: torch.as_tensor(v) for k, v in src.items()}
    qidx = 60
    damping = cdef_stage.cdef_damping(qidx)
    for cand in cdef_stage.SEARCH_SET[2:4]:
        jf = jcdef.cdef_apply(rec, skip16, cand, damping)
        tf_ = cdef_stage.cdef_apply(t, skip16, cand, damping)
        np.testing.assert_array_equal(
            cdef_stage._sb_sse(ts, tf_).numpy().astype(np.float64),
            jcdef._sb_sse(src, jf))
    got = cdef_stage.cdef_search_sb(ts, t, skip16, qidx)
    want = jcdef.cdef_search_sb(src, rec, skip16, qidx)
    assert got[0] == want[0] > 0 and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[2] == -1).any() and len(set(got[2][got[2] >= 0])) > 1
    out = cdef_stage.cdef_apply(t, skip16, got[1], damping, sb_idx=got[2])
    ref = jcdef.cdef_apply(rec, skip16, want[1], damping, sb_idx=want[2])
    for p in "yuv":
        np.testing.assert_array_equal(out[p].numpy(), ref[p])
    print(f"cdef_bits {got[0]}, sets {got[1]}, index map {got[2].tolist()}")


def test_run_key_filters_per_sb_matches_jax():
    """The GOP key frames' filter program with max_bits=3: DLF levels, the
    CDEF bits / sets / index map, the deblocked and the final planes,
    exact against the JAX program's stored outputs."""
    src, rec, skip16 = _cdef_frame(seed=9)
    qidx = 40

    def jax_filters():
        from svt_av1_tpu.pipeline import gop_fast as jgf
        out, deb, fpu, idx = jgf.run_key_filters(
            src, rec, skip16, qidx, max_bits=3)
        return (*(np.asarray(out[p]) for p in "yuv"),
                *(np.asarray(deb[p]) for p in "yuv"),
                np.array(fpu["filter_level"] + fpu["filter_level_uv"]),
                np.array([fpu["cdef_bits"]]),
                np.array(fpu["cdef_strength_list"] or [fpu["cdef_strengths"]]),
                np.asarray(idx if idx is not None else [[-2]]))

    want = port_refs.jax_ref("run_key_filters_sb", jax_filters,
                             *(src[p] for p in "yuv"),
                             *(rec[p] for p in "yuv"), skip16)
    out, deb, fpu, idx = gop_fast.run_key_filters(
        src, {k: torch.as_tensor(v) for k, v in rec.items()}, skip16, qidx,
        max_bits=3)
    for i, p in enumerate("yuv"):
        np.testing.assert_array_equal(out[p].numpy(), want[i], err_msg=p)
        np.testing.assert_array_equal(deb[p].numpy(), want[3 + i],
                                      err_msg=p)
    assert list(fpu["filter_level"] + fpu["filter_level_uv"]) == \
        want[6].tolist()
    assert fpu["cdef_bits"] == int(want[7][0]) > 0
    assert [list(s) for s in fpu["cdef_strength_list"]] == want[8].tolist()
    np.testing.assert_array_equal(idx, want[9])
