"""The tools no preset turns on, which only a feature override
(SVT_TPU_FEAT, SVT_TPU_EXACT_RATES) reaches, in the port against the JAX
package on the CPU.

- adapted_rates: codec/rate_est.py's ``adapted_decision_tables`` and
  ``md_rate_args(cdf_state=...)`` (with and without exact rates, and under
  SVT_TPU_EXACT_RATES) equal the JAX functions on the default and on an
  adapted FrameCDFs.  A GOP coded with the override is the JAX package's
  stream and not the port's stream without it (the port once ignored the
  override and coded with the static tables).
- rdoq: ``ops/rdoq.optimize_levels`` equals the JAX function on seeded
  blocks (TX_16X16 DCT_DCT on a frame quantizer, the tx-search types on
  per-block rows, the 8x8 and 4x4 types of the chroma step); a level that
  differs is allowed only on a float32 cost tie, counted and printed.
  The reference's own properties: the model cost never rises, and
  dqcoeff is the normative dequantization of the levels.  One luma wave
  step with RDOQ after K1's plain twin and one on the tx-search groups,
  against the JAX steps.
- hp_mv: ``mc.mc_blocks`` with odd MVs at every filter kind, P1 with
  1/8-pel MVs at M10 and at M6 (8x8 split, OBMC, inter-intra), and a
  2-stream multi-stream step, against the JAX outputs.
- Streams through ``Encoder``, byte-identical to the JAX package's and
  decoded by the port's decoder to every shown recon: the reference's
  own hp_mv and rdoq settings (tests/test_gop_hierarchical.py::
  test_hier_fast_hp_mv_roundtrip, tests/test_rdoq.py::
  test_e2e_roundtrip_with_rdoq), rdoq at M10 through send_picture and
  send_pictures (K1's route), adapted_rates at M10 and M12, the three
  together, and SVT_TPU_EXACT_RATES=0.

The JAX outputs are stored in tests/golden/torch_port_refs.npz (see
tests/port_refs.py), each fingerprint with the override in it; remake
them with ``JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py
tests/test_torch_feature_overrides.py``.  Nothing here encodes with JAX
live.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
import test_torch_gop as tg
import test_torch_gop_m6 as tm6
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import cdf as tcdf
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec import rate_est as trate
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.codec.syntax import TileEncoder
from svt_av1_tpu_torch.ops import mc, quant
from svt_av1_tpu_torch.ops import rdoq as trdoq
from svt_av1_tpu_torch.ops import transforms as tf
from svt_av1_tpu_torch.parallel import multistream as ms
from svt_av1_tpu_torch.pipeline import gop_fast as tgf
from svt_av1_tpu_torch.pipeline import intra_encoder as tie
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)
CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


@contextlib.contextmanager
def overrides(feat="", exact=None):
    """SVT_TPU_FEAT (and SVT_TPU_EXACT_RATES unless None) set for both
    packages while the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        if feat:
            mp.setenv("SVT_TPU_FEAT", feat)
        else:
            mp.delenv("SVT_TPU_FEAT", raising=False)
        if exact is None:
            mp.delenv("SVT_TPU_EXACT_RATES", raising=False)
        else:
            mp.setenv("SVT_TPU_EXACT_RATES", exact)
        yield


# ------------------------------------------------------- rate tables ---

@functools.lru_cache(maxsize=None)
def _adapted_state(qindex=120):
    """The port's FrameCDFs after entropy-coding a 64x64 M10 key frame."""
    y, u, v = clips.natural_clip(1, 64, 64, seed=31)[0]
    dec, _ = tie.encode_intra_frame(y, u, v, qindex,
                                    modes=features_for(10).intra_modes,
                                    device="cpu")
    tenc = TileEncoder(64, 64, qindex, frame_is_intra=True)
    tenc.encode(dec)
    return tenc.cdfs


def _jax_cdfs(port_cdfs, qindex):
    """The same CDF state as a FrameCDFs of the JAX package."""
    from svt_av1_tpu.codec.cdf import FrameCDFs as JFrameCDFs
    j = JFrameCDFs(qindex)
    j.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray) else v
                       for k, v in vars(port_cdfs).items()})
    return j


def _flat(rt):
    """An md_rate_args tuple of either package as float64 numpy arrays
    (CoefTables field by field)."""
    out = []
    for a in rt:
        if hasattr(a, "_fields"):
            out += [np.asarray(f, np.float64) for f in a]
        else:
            out.append(np.asarray(a, np.float64))
    return out


@pytest.mark.parametrize("state", ["default", "adapted"])
def test_adapted_decision_tables_match_jax(state):
    from svt_av1_tpu.codec import rate_est as jrate
    c = (_adapted_state() if state == "adapted"
         else tcdf.FrameCDFs(120))
    got = trate.adapted_decision_tables(c)
    ref = jrate.adapted_decision_tables(_jax_cdfs(c, 120))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if state == "adapted":
        base = trate.adapted_decision_tables(tcdf.FrameCDFs(120))
        assert not np.array_equal(got["coef_y"], base["coef_y"])


@pytest.mark.parametrize("exact,env", [(False, None), (True, None),
                                       (False, "1"), (True, "0"),
                                       (True, "")])
@pytest.mark.parametrize("state", [None, "adapted"])
def test_md_rate_args_match_jax(state, exact, env):
    """md_rate_args of an inter frame, with and without an adapted CDF
    state, equal the JAX function's slot for slot (SVT_TPU_EXACT_RATES
    wins over ``exact`` in both)."""
    from svt_av1_tpu.codec import rate_est as jrate
    modes = features_for(10).intra_modes
    c = _adapted_state() if state else None
    with overrides(exact=env):
        got = trate.md_rate_args(120, modes, tie.UV_MODES, c,
                                 inter_frame=True, exact=exact, device=CPU)
        ref = jrate.md_rate_args(120, modes, tie.UV_MODES,
                                 None if c is None else _jax_cdfs(c, 120),
                                 inter_frame=True, exact=exact)
    want_exact = exact if env is None else env not in ("0", "")
    assert hasattr(got[0], "_fields") == want_exact
    g, r = _flat(got), _flat(ref)
    assert len(g) == len(r)
    for i, (a, b) in enumerate(zip(g, r)):
        np.testing.assert_array_equal(a, b, err_msg=f"slot {i}")


# -------------------------------------------------------------- rdoq ---

# name: (tx_size, n, tx types, per-block rows, plane bundle)
RDOQ_CASES = {
    "dct16_frame": (cc.TX_16X16, 16, (cc.DCT_DCT,), False, "rq_y"),
    "txsearch16_rows": (cc.TX_16X16, 16, tie.TX_SEARCH_SET, True, "rq_y"),
    "chroma8": (cc.TX_8X8, 8, tie.UV_TX_TYPES, False, "rq_uv"),
    "chroma4_rows": (cc.TX_4X4, 4, tie.UV_TX_TYPES, True, "rq_uv"),
}


def _rdoq_inputs(name, t, seed):
    """Seeded residual blocks through the port's forward transform and
    quantizer: (coeffs, qcoeff, dequant field, tbl, lam, s2, qp rows)."""
    tx, n, _, rows, plane = RDOQ_CASES[name]
    rng = np.random.default_rng(seed)
    b = 48
    amp = rng.choice([6, 20, 60, 160], b)[:, None, None]
    resid = (rng.uniform(-1, 1, (b, n, n)) * amp).astype(np.int32)
    coeffs = tf.fwd_txfm2d(T(resid), t, tx)
    if rows:
        qs = rng.integers(40, 230, b)
        qp = quant.QuantParams(*(torch.stack(
            [quant.params_on(int(q), CPU)[k] for q in qs])
            for k in range(5)))
        lam = torch.tensor([tie.frame_lambda(int(q)) for q in qs])
        qidx = int(qs[0])
    else:
        qidx = int(rng.integers(40, 230))
        qp = quant.params_on(qidx, CPU)
        lam = torch.tensor(tie.frame_lambda(qidx))
    qc, _ = quant.quantize(coeffs, qp, tx)
    tbl = trate.rdoq_tables_for_qindex(qidx)[plane][:64 + n * n + 1]
    s2 = np.float32(tf.coeff_sse_scale(tx, t))
    return (coeffs, qc, quant.dequant_field(qp, n, n), T(tbl), lam, s2, qp)


def _jax_rdoq(name, t, inputs):
    import jax
    import jax.numpy as jnp
    from svt_av1_tpu.ops import rdoq as jrdoq
    tx = RDOQ_CASES[name][0]
    coeffs, qc, deq, tbl, lam, s2, _ = inputs
    f = jax.jit(lambda c, q, d, tb_, la: jrdoq.optimize_levels(
        c, q, d, tx, t, tb_, la, s2))
    return f(*(jnp.asarray(a.numpy()) for a in (coeffs, qc, deq, tbl, lam)))


def _model_cost(c_abs, l, dqv, tbl, lam, s2):
    """The model cost RDOQ minimizes, in float64 (tests/test_rdoq.py)."""
    nn = c_abs.shape[0]
    nz = np.nonzero(l)[0]
    eob = int(nz.max()) + 1 if nz.size else 0
    dq = l * dqv
    keep = s2 * (c_abs - dq) ** 2 + lam * tbl[np.minimum(l, 63)]
    zero = s2 * c_abs ** 2
    return (keep[:eob].sum() + zero[eob:].sum()
            + lam * tbl[64 + min(eob, nn)])


@pytest.mark.parametrize("name", sorted(RDOQ_CASES))
def test_optimize_levels_matches_jax(name):
    """Every tx type of the case: levels and dqcoeff equal the JAX
    function's, a differing block allowed only where the two results'
    model costs lie within float32 rounding (counted, printed); the
    model cost never rises over the quantizer's levels, and dqcoeff is
    quant.dequantize of the levels."""
    tx, n, types, _, _ = RDOQ_CASES[name]
    ties = changed = blocks = 0
    for ti, t in enumerate(types):
        inputs = _rdoq_inputs(name, t, 100 * ti + n)
        coeffs, qc, deq, tbl, lam, s2, qp = inputs
        got_q, got_dq = trdoq.optimize_levels(coeffs, qc, deq, tx, t, tbl,
                                              lam, float(s2))
        ref_q, ref_dq = port_refs.jax_ref(
            f"rdoq_{name}_{t}", lambda: _jax_rdoq(name, t, inputs),
            *(a.numpy() for a in (coeffs, qc, deq, tbl, lam)), s2)
        scan = trdoq._scan_for(tx, t)
        lam_b = np.broadcast_to(lam.numpy(), (coeffs.shape[0],))
        dqv = deq.numpy().reshape(deq.shape[0], -1)[:, scan]
        dqv = np.broadcast_to(dqv, (coeffs.shape[0], n * n))
        tb_ = tbl.numpy().astype(np.float64)
        for i in range(coeffs.shape[0]):
            c_s = np.abs(coeffs[i].numpy().reshape(-1)[scan]).astype(
                np.float64)
            l0, lg, lr = (np.abs(a.reshape(-1)[scan]) for a in (
                qc[i].numpy(), got_q[i].numpy(), ref_q[i]))
            cost = lambda l: _model_cost(c_s, l, dqv[i], tb_,
                                         float(lam_b[i]), float(s2))
            assert cost(lg) <= cost(l0) * (1 + 1e-6) + 1e-3
            if not np.array_equal(lg, lr):
                assert abs(cost(lg) - cost(lr)) <= 1e-6 * cost(lr), (t, i)
                ties += 1
            changed += int((lg != l0).any())
        blocks += coeffs.shape[0]
        np.testing.assert_array_equal(
            got_dq.numpy(), quant.dequantize(got_q, qp, tx).numpy())
        same = (got_q.numpy() == ref_q).all(axis=(1, 2))
        np.testing.assert_array_equal(got_dq.numpy()[same], ref_dq[same])
    print(f"rdoq {name}: {blocks} blocks, {changed} changed by RDOQ, "
          f"{ties} float32 cost ties against JAX")
    assert changed > 0


def _wave(tx_search):
    """One luma wave over every 16x16 block of a 64x64 plane: DCT_DCT
    only (K1's route) or the tx-search candidates."""
    src, recon, by, bx = _wave_inputs()
    modes = features_for(8 if tx_search else 10).intra_modes
    if tx_search:
        cand, txs = tie.expand_tx_cands(modes)
        mode_ids = tuple(m for m, _ in cand)
    else:
        cand, txs, mode_ids = modes, None, modes
    return src, recon, by, bx, cand, txs, mode_ids


def _wave_inputs():
    rng = np.random.default_rng(5)
    y = clips.natural_clip(1, 64, 64, seed=5)[0][0].astype(np.int32)
    recon = np.clip(y + rng.integers(-6, 7, y.shape), 0, 255).astype(
        np.int32)
    by, bx = np.divmod(np.arange(16), 4)
    return y, recon, by, bx


def _jax_wave(src, recon, by, bx, cand, txs, mode_ids, qindex):
    import jax
    import jax.numpy as jnp
    from svt_av1_tpu.codec import rate_est as jrate
    from svt_av1_tpu.ops import quant as jq
    from svt_av1_tpu.pipeline import intra_encoder as jie
    qp = jq.make_quant_params(qindex)
    rt = jrate.md_rate_args(qindex, mode_ids, tie.UV_MODES, exact=True)
    b = by.size
    f = jax.jit(lambda rec, s, rates, rq: jie._rd_step(
        rec, s, jnp.asarray(by * 16), jnp.asarray(bx * 16),
        jnp.ones(b, bool), jnp.asarray(by > 0), jnp.asarray(bx > 0),
        tuple(jnp.asarray(a) for a in qp), jnp.float32(
            tie.frame_lambda(qindex)), 16, cc.TX_16X16, cand, 0,
        tx_types=txs, tr_avail=jnp.zeros(b, bool),
        bl_avail=jnp.zeros(b, bool), rates=rates, rdoq=True, rdoq_tbl=rq,
        return_index=txs is not None))
    return f(jnp.asarray(recon), jnp.asarray(src),
             (rt[0], rt[2], rt[3], rt[5]), jnp.asarray(rt[7]))


@pytest.mark.parametrize("tx_search", [False, True])
def test_rd_step_rdoq_matches_jax(tx_search):
    """A luma wave with RDOQ: after K1's plain twin (one DCT_DCT pass on
    a frame quantizer) or on the tx-search groups; the modes, levels and
    recon equal the JAX step's, and RDOQ changed some level."""
    qindex = 160
    src, recon, by, bx, cand, txs, mode_ids = _wave(tx_search)
    m_j, q_j, r_j = port_refs.jax_ref(
        f"rdoq_wave_{tx_search}",
        lambda: _jax_wave(src, recon, by, bx, cand, txs, mode_ids, qindex),
        src, recon, np.array(mode_ids), qindex, np.array(["rdoq=1"]))
    rt = trate.md_rate_args(qindex, mode_ids, tie.UV_MODES, exact=True,
                            device=CPU)
    b = by.size
    outs = {}
    for rdoq in (False, True):
        rec_t = T(recon)[None].clone()
        m_t, q_t, _ = tie._rd_step(
            rec_t, T(src)[None], torch.zeros(b, dtype=torch.int64),
            T(by * 16), T(bx * 16), torch.arange(b), T(by > 0), T(bx > 0),
            quant.params_on(qindex, CPU),
            torch.tensor(tie.frame_lambda(qindex)), cand,
            (rt[0], rt[2], rt[3], rt[5]), tx_types=txs,
            tr_avail=torch.zeros(b, dtype=torch.bool),
            bl_avail=torch.zeros(b, dtype=torch.bool),
            return_index=txs is not None,
            rdoq_tbl=rt[7] if rdoq else None)
        outs[rdoq] = (m_t.numpy(), q_t.numpy(), rec_t[0].numpy())
    m_t, q_t, rec = outs[True]
    np.testing.assert_array_equal(m_t, np.asarray(m_j))
    np.testing.assert_array_equal(q_t, np.asarray(q_j))
    np.testing.assert_array_equal(rec, np.asarray(r_j))
    changed = int((outs[False][1] != q_t).any(axis=(1, 2)).sum())
    print(f"rdoq wave (tx search {tx_search}): {b} blocks equal, "
          f"{changed} differ from the wave without RDOQ")
    assert changed > 0


# -------------------------------------------------------------- hp_mv ---

def _jax_mc(ref, ys, xs, mvs, blk, ss, kind):
    import jax.numpy as jnp
    from svt_av1_tpu.ops import mc as jmc
    return jmc.mc_blocks(jnp.asarray(ref), jnp.asarray(ys), jnp.asarray(xs),
                         jnp.asarray(mvs), blk, jmc.PAD, ss, 8, kind=kind)


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_mc_blocks_odd_mvs_match_jax(kind):
    """1/8-pel (odd) MVs through mc_blocks, luma and chroma, exact."""
    rng = np.random.default_rng(kind)
    y = clips.natural_clip(1, 64, 64, seed=9)[0][0]
    for ss, blk in ((0, 16), (1, 8)):
        plane = y if ss == 0 else y[::2, ::2].copy()
        ref = mc.pad_plane(T(plane), mc.PAD >> ss).numpy()
        g = plane.shape[0] // blk
        ys, xs = (np.divmod(np.arange(g * g), g)[i] * blk for i in (0, 1))
        mvs = (rng.integers(-40, 40, (g * g, 2)) * 2 + 1).astype(np.int32)
        got = mc.mc_blocks(T(ref), T(ys), T(xs), T(mvs), blk, mc.PAD, ss, 8,
                           kind=kind)
        (want,) = port_refs.jax_ref(
            f"mc_odd_{kind}_{ss}",
            lambda: (_jax_mc(ref, ys, xs, mvs, blk, ss, kind),),
            ref, ys, xs, mvs)
        np.testing.assert_array_equal(got.numpy(), want)


def hp_pan_clip(n=5, h=64, w=64):
    """The reference's 1/8-pel test clip: a smooth sinusoid panning 0.6
    px a frame (tests/test_gop_hierarchical.py)."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 0.6 * t) / 5.0)
                    + 40 * np.cos(yy / 7.0), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        frames.append((y, u.copy(), u.copy()))
    return frames


# name: (preset, tools (obmc, interintra, tx_search, split8))
P1_CASES = {"m10": (10, (False, False, False, False)),
            "m6": (6, (True, True, True, True))}


def _p1_inputs(name):
    """(src_pack, refs, R): M10, frame 2 of the 1/8-pel pan from frame 1;
    M6, the fault clip's frame 2 from frame 1, where every M6 tool fires
    (tests/test_torch_gop_m6.py)."""
    if name == "m6":
        return tm6._p1_inputs(1) + (1,)
    fr = hp_pan_clip(3, 64, 96)
    y, u, v = fr[2]
    src_pack = np.concatenate([y, np.concatenate([u, v], 1)], 0)
    return (src_pack, tuple(p[None].astype(np.int32) for p in fr[1]), 1)


def _jax_p1_hp(src_pack, refs, R, name):
    from svt_av1_tpu.codec.rate_est import md_rate_args as jrate
    from svt_av1_tpu.ops import quant as jq
    from svt_av1_tpu.pipeline import gop_fast as jgf
    preset, (obmc, ii, txs, sp8) = P1_CASES[name]
    feat = features_for(preset)
    modes = tuple(feat.intra_modes)
    rt = jrate(tg.QINDEX, modes, tie.UV_MODES, None, inter_frame=True,
               exact=feat.exact_rates)
    p1 = jgf._jit_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                     feat.hme_rad2, feat.hme_rad0, True, obmc, ii, True,
                     txs, sp8)
    return p1(src_pack, *refs, *jq.make_quant_params(tg.QINDEX),
              tgf.frame_lambda(tg.QINDEX), *rt[:7])


def _port_p1_hp(src_pack, refs, R, name):
    preset, (obmc, ii, txs, sp8) = P1_CASES[name]
    feat = features_for(preset)
    modes = tuple(feat.intra_modes)
    rt = trate.md_rate_args(tg.QINDEX, modes, tie.UV_MODES, inter_frame=True,
                            exact=feat.exact_rates, device=CPU)
    p1 = tgf.build_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                      feat.hme_rad2, feat.hme_rad0, True, obmc, ii, True,
                      txs, sp8)
    outs = p1(*tgf._src_planes(src_pack, 64, 96, CPU),
              *(torch.as_tensor(r) for r in refs),
              quant.params_on(tg.QINDEX, CPU),
              torch.tensor(tgf.frame_lambda(tg.QINDEX)), rt)
    return [o.numpy() for o in outs]


def odd_mvs(mv):
    """Blocks whose (row, col) MV has an odd component (1/8 pel)."""
    mv = np.asarray(mv).reshape(-1, 2)
    return int(((mv[:, 0] | mv[:, 1]) & 1).astype(bool).sum())


@pytest.mark.parametrize("name", sorted(P1_CASES))
def test_p1_hp_matches_jax(name):
    """P1 with 1/8-pel MVs against the JAX P1 with hp: every block's
    decisions equal, then the recon and merges exactly (at M6, as
    tests/test_torch_gop_m6.py allows, the first differing block in wave
    order may be an OBMC choice next to a split neighbour); odd MVs are
    chosen."""
    src_pack, refs, R = _p1_inputs(name)
    ref = port_refs.jax_ref(f"p1_hp_{name}",
                            lambda: _jax_p1_hp(src_pack, refs, R, name),
                            src_pack, *refs, np.array(["hp_mv=1"]))
    got = _port_p1_hp(src_pack, refs, R, name)
    o, r = dict(zip(tg.P1_OUT, got)), dict(zip(tg.P1_OUT, ref))
    diff = tm6._block_diff(got, ref)
    odd = odd_mvs(o["mv"][o["choose"].astype(bool)])
    print(f"P1 hp {name}: {int(diff.sum())} of {diff.size} blocks differ; "
          f"inter {int(o['choose'].sum())}, odd MVs {odd}, split "
          f"{int(o['split'].sum())}, obmc {int(o['obmc'].sum())}")
    for k in ("gm_mats", "gm_trans", "gm_kinds", "interp"):
        np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    if diff.any():
        assert name == "m6" and tm6._first_difference(diff, o, r)[1]
    else:
        for k in tg.P1_OUT:
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    assert odd > 0


def _hp_step_inputs():
    """Two streams of the 1/8-pel pan (one shifted by 3 px), frame 1
    coded from the key frame."""
    srcs, refs = [], []
    for s in range(2):
        fr = [tuple(np.roll(p, 3 * s * (i == 0), axis=1)
                    for i, p in enumerate(f)) for f in hp_pan_clip(2)]
        y, u, v = fr[1]
        srcs.append(np.concatenate([y, np.concatenate([u, v], 1)], 0))
        refs.append({1: dict(y=fr[0][0], u=fr[0][1], v=fr[0][2])})
    return srcs, refs, [120, 150]


def _jax_hp_step(srcs, refs, qs):
    from svt_av1_tpu.pipeline import gop_fast as jgf
    out = []
    for s in range(2):
        p = jgf.run_inter_frame(srcs[s], refs[s], qs[s], 64, 64,
                                tie.MODES[:4], hp=True)
        out += [np.asarray(a) for a in list(p.outs) + list(p.p2_outs)]
    return out


def test_multistream_hp_step_matches_jax():
    """A 2-stream batched inter step with 1/8-pel MVs: each stream's P1
    and P2 outputs equal the JAX package's one-stream run_inter_frame
    (which its sharded step equals) and the port's one-stream encode."""
    srcs, refs, qs = _hp_step_inputs()
    ref = port_refs.jax_ref(
        "multistream_hp_step", lambda: _jax_hp_step(srcs, refs, qs),
        *srcs, *[r[1][p] for r in refs for p in "yuv"], np.asarray(qs),
        np.array(["hp_mv=1"]))
    pends = ms.run_inter_frames_batched(srcs, refs, qs, tie.MODES[:4],
                                        hp=True, device=CPU)
    n = len(pends[0].outs) + len(pends[0].p2_outs)
    odd = 0
    for s in range(2):
        got = pends[s].outs + pends[s].p2_outs
        for i, a in enumerate(got):
            np.testing.assert_array_equal(a.numpy(), ref[s * n + i],
                                          err_msg=f"stream {s} output {i}")
        one = tgf.run_inter_frame(srcs[s], refs[s], qs[s], 64, 64,
                                  tie.MODES[:4], hp=True, device=CPU)
        for a, b in zip(got, one.outs + one.p2_outs):
            assert torch.equal(a, b)
        odd += odd_mvs(pends[s].outs[7].numpy()[pends[s].outs[5].numpy()])
    print(f"multi-stream hp step: 2 streams equal, odd MVs {odd}")
    assert odd > 0


# ------------------------------------------------------------ streams ---

GOP = dict(intra_period_length=15, hierarchical_levels=2)
# name: (frames, EncoderConfig fields (qp 35 unless given), SVT_TPU_FEAT,
# SVT_TPU_EXACT_RATES, send_pictures, order hints off)
STREAMS = {
    # tests/test_gop_hierarchical.py::test_hier_fast_hp_mv_roundtrip
    "hp_m6": (hp_pan_clip, dict(qp=30, intra_period_length=31,
                                hierarchical_levels=2, enc_mode=6,
                                enable_tf=0), "hp_mv=1", None, False, True),
    # tests/test_rdoq.py::test_e2e_roundtrip_with_rdoq
    "rdoq_m6": (lambda: clips.natural_clip(1, 64, 64, seed=41),
                dict(enc_mode=6), "rdoq=1,varpart=0", None, False, False),
    "rdoq_m10_picture": (lambda: clips.natural_clip(1, 64, 64, seed=42),
                         dict(enc_mode=10), "rdoq=1", None, False, False),
    "rdoq_m10_pictures": (lambda: clips.natural_clip(2, 64, 64, seed=43),
                          dict(enc_mode=10), "rdoq=1", None, True, False),
    "adapted_m10": (lambda: clips.natural_clip(5, 64, 64, seed=44),
                    dict(enc_mode=10, **GOP), "adapted_rates=1", None,
                    False, False),
    "adapted_m12": (lambda: clips.natural_clip(5, 64, 64, seed=44),
                    dict(enc_mode=12, **GOP), "adapted_rates=1", None,
                    False, False),
    "all_m10": (hp_pan_clip, dict(enc_mode=10, **GOP),
                "hp_mv=1,rdoq=1,adapted_rates=1", None, False, False),
    "exact0_m10": (lambda: clips.natural_clip(5, 64, 64, seed=44),
                   dict(enc_mode=10, **GOP), "", "0", False, False),
}


def drive(enc_cls, cfg_cls, name, plain=False, device=None):
    """Packets of a STREAMS case through one package's Encoder, with the
    case's overrides (none if ``plain``)."""
    make, fields, feat, exact, batched, no_hints = STREAMS[name]
    frames = make()
    h, w = frames[0][0].shape
    kw = {} if device is None else dict(device=device)
    with overrides(*(("", None) if plain else (feat, exact))):
        enc = enc_cls(cfg_cls(source_width=w, source_height=h,
                              **dict(dict(qp=35), **fields)), **kw)
        if no_hints:
            # the reference test pins order hints off, so that skip mode
            # does not out-RD the NEWMV blocks it needs
            enc.sp.enable_order_hint = False
        if batched:
            enc.send_pictures(frames, eos=True)
        else:
            for i, fr in enumerate(frames):
                enc.send_picture(*fr, eos=i == len(frames) - 1)
        return list(iter(enc.get_packet, None))


def _jax_stream(name):
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    pkts = drive(JEncoder, JConfig, name)
    return [np.frombuffer(p.data, np.uint8) for p in pkts]


@functools.lru_cache(maxsize=None)
def run_stream(name, plain=False):
    """(the port's packets, the levels RDOQ changed while coding them)."""
    changed = [0]
    orig = trdoq.optimize_levels

    def spy(coeffs, qcoeff, *a, **kw):
        q, dq = orig(coeffs, qcoeff, *a, **kw)
        changed[0] += int((q != qcoeff).sum())
        return q, dq

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trdoq, "optimize_levels", spy)
        pkts = drive(Encoder, EncoderConfig, name, plain, device="cpu")
    return pkts, changed[0]


def stored_stream(name):
    make, fields, feat, exact, batched, no_hints = STREAMS[name]
    frames = make()
    ref = port_refs.jax_ref(
        f"override_stream_{name}", lambda: _jax_stream(name),
        *[a for f in frames for a in f],
        np.array(sorted((k, str(v)) for k, v in fields.items()), str),
        np.array([feat, str(exact), str(batched), str(no_hints)]))
    return [bytes(a) for a in ref]


def decode(pkts):
    """The port's decoder over a stream: every shown frame equals its
    Packet.recon; returns the count of inter blocks with odd MVs."""
    dec = Decoder(device="cpu")
    shown = [p for p in pkts if p.displayed]
    got, odd = [], 0
    for p in pkts:
        got += dec.decode_temporal_unit(p.data)
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]:
            odd += sum(1 for d in dec.last_decisions.values()
                       if d.is_inter and (d.mv[0] | d.mv[1]) & 1)
    assert len(got) == len(shown)
    for r, p in zip(got, shown):
        for k in "yuv":
            np.testing.assert_array_equal(r[k], p.recon[k],
                                          err_msg=f"poc {p.pts} {k}")
    return odd


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_jax(name):
    """Byte-identical to the JAX package's stream and decoded to every
    shown recon; the hp streams code odd MVs, the rdoq streams change
    levels, the adapted streams differ from the streams without the
    override."""
    pkts, changed = run_stream(name)
    assert [p.data for p in pkts] == stored_stream(name), name
    odd = decode(pkts)
    feat = STREAMS[name][2]
    msg = (f"{name}: {len(pkts)} packets, {sum(len(p.data) for p in pkts)} "
           f"bytes, odd MVs {odd}, levels changed by RDOQ {changed}")
    if "hp_mv" in feat:
        assert odd > 0
    if "rdoq" in feat:
        assert changed > 0
    if "adapted" in feat or STREAMS[name][3] is not None:
        plain, _ = run_stream(name, plain=True)
        assert [p.data for p in pkts] != [p.data for p in plain]
        msg += ", differs from the stream without the override"
    print(msg)


def test_adapted_rates_fault_repaired():
    """A 64x64 M10 levels-2 GOP with SVT_TPU_FEAT=adapted_rates=1 is the
    JAX package's stream, which the port's own stream without the
    override is not: the port once ignored the override (it never kept
    the primary-ref chain's CDFs nor passed them at dispatch) and coded
    the static tables' stream."""
    pkts, _ = run_stream("adapted_m10")
    plain, _ = run_stream("adapted_m10", plain=True)
    jax = stored_stream("adapted_m10")
    assert [p.data for p in pkts] == jax
    assert [p.data for p in plain] != jax
