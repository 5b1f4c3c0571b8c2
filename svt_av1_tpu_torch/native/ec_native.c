/*
 * Native entropy-coding backend: daala od_ec range encoder + the
 * coefficient (txb) inner loop, as a CPython extension.
 *
 * Same normative algorithms as svt_av1_tpu_torch/codec/entropy.py and
 * codec/coeff.py (which remain the reference implementation and test
 * mirror); this is the production host path — the analog of the
 * reference encoder's native EC stage (entropy_coding.c).
 *
 * CDF tables are passed as writable uint16 numpy buffers so adaptation
 * stays visible to the Python layer.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CDF_PROB_TOP 32768
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4

/* ------------------------------------------------------------------ */
/* range encoder                                                       */
/* ------------------------------------------------------------------ */

typedef struct {
    uint32_t low;
    uint32_t rng;
    int32_t cnt;
    uint16_t *pre;     /* precarry buffer */
    size_t pre_len;
    size_t pre_cap;
} OdEc;

static void ec_reset(OdEc *e) {
    e->low = 0;
    e->rng = 0x8000;
    e->cnt = -9;
    e->pre_len = 0;
}

static void ec_grow(OdEc *e, size_t need) {
    if (e->pre_len + need > e->pre_cap) {
        size_t cap = e->pre_cap * 2 + need + 64;
        e->pre = (uint16_t *)realloc(e->pre, cap * sizeof(uint16_t));
        e->pre_cap = cap;
    }
}

static int ilog_nz(uint32_t x) {
    int n = 0;
    while (x) { n++; x >>= 1; }
    return n;
}

static void ec_normalize(OdEc *e, uint32_t low, uint32_t rng) {
    int d = 16 - ilog_nz(rng);
    int c = e->cnt;
    int s = c + d;
    if (s >= 0) {
        uint32_t m;
        ec_grow(e, 2);
        c += 16;
        m = ((uint32_t)1 << c) - 1;
        if (s >= 8) {
            e->pre[e->pre_len++] = (uint16_t)(low >> c);
            low &= m;
            c -= 8;
            m >>= 8;
        }
        e->pre[e->pre_len++] = (uint16_t)(low >> c);
        s = c + d - 24;
        low &= m;
    }
    e->low = low << d;
    e->rng = (rng << d) & 0xFFFF;
    e->cnt = s;
}

static void ec_encode_q15(OdEc *e, unsigned fl, unsigned fh, int s, int nsyms) {
    uint32_t l = e->low;
    uint32_t r = e->rng;
    const int n = nsyms - 1;
    if (fl < CDF_PROB_TOP) {
        unsigned u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (n - (s - 1));
        unsigned v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (n - s);
        l += r - u;
        r = u - v;
    } else {
        r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
             + EC_MIN_PROB * (n - s);
    }
    ec_normalize(e, l, r);
}

static void ec_encode_symbol(OdEc *e, int s, const uint16_t *icdf, int nsyms) {
    ec_encode_q15(e, s > 0 ? icdf[s - 1] : CDF_PROB_TOP, icdf[s], s, nsyms);
}

static void ec_encode_bool(OdEc *e, int val, unsigned f) {
    uint32_t l = e->low;
    uint32_t r = e->rng;
    unsigned v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                 + EC_MIN_PROB;
    if (val) {
        l += r - v;
        r = v;
    } else {
        r -= v;
    }
    ec_normalize(e, l, r);
}

/* normative CDF adaptation (inverted convention, trailing counter) */
static void cdf_update(uint16_t *icdf, int val, int nsyms) {
    int count = icdf[nsyms];
    int speed = 0;
    {
        int t = nsyms, lg = 0;
        while (t > 1) { t >>= 1; lg++; }
        if (nsyms > (1 << lg)) lg++;   /* bit_length(nsyms) - 1 rounding */
    }
    /* rate = 3 + (count>15) + (count>31) + min(bitlen(nsyms)-1, 2) */
    {
        int bl = 0, t = nsyms;
        while (t) { bl++; t >>= 1; }
        speed = bl - 1;
        if (speed > 2) speed = 2;
    }
    {
        int rate = 3 + (count > 15) + (count > 31) + speed;
        int i;
        for (i = 0; i < nsyms - 1; i++) {
            int cur = icdf[i];
            if (i < val)
                icdf[i] = (uint16_t)(cur + ((CDF_PROB_TOP - cur) >> rate));
            else
                icdf[i] = (uint16_t)(cur - (cur >> rate));
        }
        icdf[nsyms] = (uint16_t)(count + (count < 32));
    }
}

static PyObject *ec_done_bytes(OdEc *e) {
    uint32_t l = e->low;
    int c = e->cnt;
    int s = 10 + c;
    uint32_t m = 0x3FFF;
    uint32_t eo = ((l + m) & ~m) | (m + 1);
    size_t n0;
    if (s > 0) {
        uint32_t n = ((uint32_t)1 << (c + 16)) - 1;
        ec_grow(e, (s + 7) >> 3);
        do {
            e->pre[e->pre_len++] = (uint16_t)(eo >> (c + 16));
            eo &= n;
            s -= 8;
            c -= 8;
            n >>= 8;
        } while (s > 0);
    }
    n0 = e->pre_len;
    {
        PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n0);
        unsigned char *buf = (unsigned char *)PyBytes_AS_STRING(out);
        uint32_t carry = 0;
        size_t i;
        for (i = n0; i-- > 0;) {
            uint32_t v = e->pre[i] + carry;
            buf[i] = (unsigned char)v;
            carry = v >> 8;
        }
        return out;
    }
}

/* ------------------------------------------------------------------ */
/* python object                                                       */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    OdEc ec;
} EncObj;

static PyObject *Enc_new(PyTypeObject *type, PyObject *a, PyObject *k) {
    EncObj *self = (EncObj *)type->tp_alloc(type, 0);
    if (self) {
        memset(&self->ec, 0, sizeof(OdEc));
        ec_reset(&self->ec);
    }
    return (PyObject *)self;
}

static void Enc_dealloc(EncObj *self) {
    free(self->ec.pre);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int get_u16_buffer(PyObject *obj, Py_buffer *view) {
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE))
        return -1;
    return 0;
}

static PyObject *Enc_encode_symbol(EncObj *self, PyObject *args) {
    int s, nsyms, update;
    PyObject *cdf_obj;
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "iOip", &s, &cdf_obj, &nsyms, &update))
        return NULL;
    if (get_u16_buffer(cdf_obj, &view))
        return NULL;
    {
        uint16_t *cdf = (uint16_t *)view.buf;
        ec_encode_symbol(&self->ec, s, cdf, nsyms);
        if (update)
            cdf_update(cdf, s, nsyms);
    }
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

static PyObject *Enc_encode_bool(EncObj *self, PyObject *args) {
    int val;
    unsigned f;
    if (!PyArg_ParseTuple(args, "iI", &val, &f))
        return NULL;
    ec_encode_bool(&self->ec, val, f);
    Py_RETURN_NONE;
}

static PyObject *Enc_encode_literal(EncObj *self, PyObject *args) {
    unsigned v;
    int bits, i;
    if (!PyArg_ParseTuple(args, "Ii", &v, &bits))
        return NULL;
    for (i = bits - 1; i >= 0; i--)
        ec_encode_bool(&self->ec, (v >> i) & 1, 16384);
    Py_RETURN_NONE;
}

static PyObject *Enc_done(EncObj *self, PyObject *noarg) {
    return ec_done_bytes(&self->ec);
}

static PyObject *Enc_tell_bits(EncObj *self, PyObject *noarg) {
    return PyLong_FromLong(self->ec.cnt + 10 + (long)self->ec.pre_len * 8);
}

/* ------------------------------------------------------------------ */
/* coefficient block encoding (the hot loop)                           */
/* ------------------------------------------------------------------ */

#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4
#define COEFF_CONTEXT_BITS 6
#define COEFF_CONTEXT_MASK 63
#define TX_PAD_HOR 4

static const int16_t k_eob_group_start[12] =
    {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
static const int16_t k_eob_offset_bits[12] =
    {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};

static int eob_pos_token(int eob, int *extra) {
    int t;
    if (eob < 2) t = eob;
    else if (eob < 3) t = 2;
    else if (eob < 5) t = 3;
    else if (eob < 9) t = 4;
    else if (eob < 17) t = 5;
    else if (eob < 33) t = 6;
    else if (eob < 65) t = 7;
    else if (eob < 129) t = 8;
    else if (eob < 257) t = 9;
    else if (eob < 513) t = 10;
    else t = 11;
    *extra = eob - k_eob_group_start[t];
    return t;
}

static int clip3u(int v, int hi) { return v > hi ? hi : v; }

/* base-level context from padded levels */
static int nz_ctx(const uint8_t *levels, int stride, int pos, int bwl,
                  int wlog_mask, const int8_t *ctx_offsets, int tx_class) {
    int row = pos >> bwl;
    int col = pos & wlog_mask;
    const uint8_t *lv = levels + row * stride + col;
    int mag;
    if (tx_class == TX_CLASS_2D) {
        if (pos == 0) return 0;
        mag = clip3u(lv[1], 3) + clip3u(lv[stride], 3)
            + clip3u(lv[stride + 1], 3) + clip3u(lv[2], 3)
            + clip3u(lv[2 * stride], 3);
        return ((mag + 1) >> 1 > 4 ? 4 : (mag + 1) >> 1) + ctx_offsets[pos];
    } else if (tx_class == TX_CLASS_VERT) {
        mag = clip3u(lv[1], 3) + clip3u(lv[stride], 3)
            + clip3u(lv[2 * stride], 3) + clip3u(lv[3 * stride], 3)
            + clip3u(lv[4 * stride], 3);
        mag = (mag + 1) >> 1;
        if (mag > 4) mag = 4;
        return mag + (row == 0 ? 26 : (row == 1 ? 31 : 36));
    } else {
        mag = clip3u(lv[1], 3) + clip3u(lv[stride], 3)
            + clip3u(lv[2], 3) + clip3u(lv[3], 3) + clip3u(lv[4], 3);
        mag = (mag + 1) >> 1;
        if (mag > 4) mag = 4;
        return mag + (col == 0 ? 26 : (col == 1 ? 31 : 36));
    }
}

static int br_ctx_fn(const uint8_t *levels, int stride, int pos, int bwl,
                     int tx_class) {
    int row = pos >> bwl;
    int col = pos - (row << bwl);
    const uint8_t *lv = levels + row * stride + col;
    int mag = lv[1] + lv[stride];
    if (tx_class == TX_CLASS_2D) {
        mag += lv[stride + 1];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row < 2 && col < 2) return mag + 7;
    } else if (tx_class == TX_CLASS_HORIZ) {
        mag += lv[2];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (col == 0) return mag + 7;
    } else {
        mag += lv[2 * stride];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row == 0) return mag + 7;
    }
    return mag + 14;
}

static void write_golomb(OdEc *e, int level) {
    int x = level + 1;
    int length = 0, i, t = x;
    while (t) { length++; t >>= 1; }
    for (i = 0; i < length - 1; i++) ec_encode_bool(e, 0, 16384);
    for (i = length - 1; i >= 0; i--)
        ec_encode_bool(e, (x >> i) & 1, 16384);
}

/*
 * encode_txb(qcoeff_u8buf(int32 kh*kw), scan(int16 n), ctx_offsets(int8),
 *            kh, kw, bwl, tx_class, eob_multi_size,
 *            txb_skip_cdf, eob_cdf, eob_extra_cdf, dc_sign_cdf,
 *            base_cdf(2d 42x(5)), base_eob_cdf(4x4), br_cdf(21x5),
 *            txb_skip_ctx, dc_sign_ctx, update) -> cul_level
 * Also emits txb_skip; tx-type signaling is done by the Python caller
 * via the returned needs_tx_type flag protocol: this function only
 * handles blocks where tx_type syntax was already interleaved by
 * calling with skip_txb_skip... — simpler: caller passes a callable? No:
 * the caller encodes txb_skip itself and calls us only for eob > 0
 * after writing tx_type.  We encode from eob coding onward.
 */
/* whole-txb coefficient core (from eob token onward); returns cul_level */
static int encode_coeffs_core(OdEc *e, const int32_t *q,
                              const int16_t *scan, const int8_t *offs,
                              int kh, int kw, int bwl, int tx_class,
                              int eob_multi_size, uint16_t *eob_cdf,
                              uint16_t *eob_extra_tab, int eob_extra_w,
                              uint16_t *dc_sign_cdf, uint16_t *base_cdf,
                              int base_w, uint16_t *base_eob_cdf,
                              int beob_w, uint16_t *br_cdf, int br_w,
                              int eob, int update) {
    int stride = kw + TX_PAD_HOR;
    uint8_t levels_buf[(32 + 4) * (32 + 4)];
    memset(levels_buf, 0, sizeof(levels_buf));
    {
        int r, c;
        for (r = 0; r < kh; r++)
            for (c = 0; c < kw; c++) {
                int32_t v = q[r * kw + c];
                int a = v < 0 ? -v : v;
                levels_buf[r * stride + c] = (uint8_t)(a > 127 ? 127 : a);
            }
    }
    {
        int extra;
        int eob_pt = eob_pos_token(eob, &extra);
        int nsyms = eob_multi_size + 5;
        ec_encode_symbol(e, eob_pt - 1, eob_cdf, nsyms);
        if (update) cdf_update(eob_cdf, eob_pt - 1, nsyms);
        {
            int ebits = k_eob_offset_bits[eob_pt];
            if (ebits > 0) {
                uint16_t *ex = eob_extra_tab + eob_pt * eob_extra_w;
                int shift = ebits - 1;
                int bit = (extra >> shift) & 1;
                int i;
                ec_encode_symbol(e, bit, ex, 2);
                if (update) cdf_update(ex, bit, 2);
                for (i = 1; i < ebits; i++) {
                    shift = ebits - 1 - i;
                    ec_encode_bool(e, (extra >> shift) & 1, 16384);
                }
            }
        }
    }
    {
        int c;
        int wmask = kw - 1;
        for (c = eob - 1; c >= 0; c--) {
            int pos = scan[c];
            int32_t v = q[pos];
            int level = v < 0 ? -v : v;
            if (c == eob - 1) {
                int ctx;
                if (c == 0) ctx = 0;
                else if (c <= (kh * kw) / 8) ctx = 1;
                else if (c <= (kh * kw) / 4) ctx = 2;
                else ctx = 3;
                {
                    int s = (level < 3 ? level : 3) - 1;
                    uint16_t *cdf = base_eob_cdf + ctx * beob_w;
                    ec_encode_symbol(e, s, cdf, 3);
                    if (update) cdf_update(cdf, s, 3);
                }
            } else {
                int ctx = nz_ctx(levels_buf, stride, pos, bwl, wmask, offs,
                                 tx_class);
                int s = level < 3 ? level : 3;
                uint16_t *cdf = base_cdf + ctx * base_w;
                ec_encode_symbol(e, s, cdf, 4);
                if (update) cdf_update(cdf, s, 4);
            }
            if (level > NUM_BASE_LEVELS) {
                int base_range = level - 1 - NUM_BASE_LEVELS;
                int bctx = br_ctx_fn(levels_buf, stride, pos, bwl, tx_class);
                uint16_t *cdf = br_cdf + bctx * br_w;
                int idx;
                for (idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
                    int k = base_range - idx;
                    if (k > BR_CDF_SIZE - 1) k = BR_CDF_SIZE - 1;
                    ec_encode_symbol(e, k, cdf, BR_CDF_SIZE);
                    if (update) cdf_update(cdf, k, BR_CDF_SIZE);
                    if (k < BR_CDF_SIZE - 1) break;
                }
            }
        }
    }
    {
        int c;
        int cul = 0;
        int32_t dc = q[0];
        for (c = 0; c < eob; c++) {
            int pos = scan[c];
            int32_t v = q[pos];
            int level = v < 0 ? -v : v;
            cul += level;
            if (level) {
                int sign = v < 0;
                if (c == 0) {
                    ec_encode_symbol(e, sign, dc_sign_cdf, 2);
                    if (update) cdf_update(dc_sign_cdf, sign, 2);
                } else {
                    ec_encode_bool(e, sign, 16384);
                }
                if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
                    write_golomb(e, level - COEFF_BASE_RANGE - 1
                                        - NUM_BASE_LEVELS);
            }
        }
        if (cul > COEFF_CONTEXT_MASK) cul = COEFF_CONTEXT_MASK;
        if (dc < 0) cul |= 1 << COEFF_CONTEXT_BITS;
        else if (dc > 0) cul += 2 << COEFF_CONTEXT_BITS;
        return cul;
    }
}

static PyObject *Enc_encode_coeffs(EncObj *self, PyObject *args) {
    PyObject *q_obj, *scan_obj, *off_obj;
    PyObject *eob_cdf_o, *eob_extra_o, *dc_sign_o, *base_o, *base_eob_o,
        *br_o;
    int kh, kw, bwl, tx_class, eob_multi_size, dc_sign_ctx, update, eob;
    if (!PyArg_ParseTuple(
            args, "OOOiiiiiOOOOOOiip", &q_obj, &scan_obj, &off_obj, &kh, &kw,
            &bwl, &tx_class, &eob_multi_size, &eob_cdf_o, &eob_extra_o,
            &dc_sign_o, &base_o, &base_eob_o, &br_o, &eob, &dc_sign_ctx,
            &update))
        return NULL;

    Py_buffer qv, sv, ov, eobv, eobxv, dcv, basev, beobv, brv;
    if (PyObject_GetBuffer(q_obj, &qv, PyBUF_C_CONTIGUOUS)) return NULL;
    if (PyObject_GetBuffer(scan_obj, &sv, PyBUF_C_CONTIGUOUS)) return NULL;
    if (PyObject_GetBuffer(off_obj, &ov, PyBUF_C_CONTIGUOUS)) return NULL;
    if (get_u16_buffer(eob_cdf_o, &eobv)) return NULL;
    if (get_u16_buffer(eob_extra_o, &eobxv)) return NULL;
    if (get_u16_buffer(dc_sign_o, &dcv)) return NULL;
    if (get_u16_buffer(base_o, &basev)) return NULL;
    if (get_u16_buffer(base_eob_o, &beobv)) return NULL;
    if (get_u16_buffer(br_o, &brv)) return NULL;

    const int32_t *q = (const int32_t *)qv.buf;
    const int16_t *scan = (const int16_t *)sv.buf;
    const int8_t *offs = (const int8_t *)ov.buf;
    uint16_t *eob_cdf = (uint16_t *)eobv.buf;
    uint16_t *eob_extra_tab = (uint16_t *)eobxv.buf;  /* (22, w) by eob_pt */
    int eob_extra_w = (int)(eobxv.len / sizeof(uint16_t) / 22);
    uint16_t *dc_sign_cdf = (uint16_t *)dcv.buf;
    uint16_t *base_cdf = (uint16_t *)basev.buf;       /* (42, base_w) */
    uint16_t *base_eob_cdf = (uint16_t *)beobv.buf;   /* (4, beob_w) */
    uint16_t *br_cdf = (uint16_t *)brv.buf;           /* (21, br_w) */
    int base_w = (int)(basev.len / sizeof(uint16_t) / 42);
    int beob_w = (int)(beobv.len / sizeof(uint16_t) / 4);
    int br_w = (int)(brv.len / sizeof(uint16_t) / 21);

    {
        int cul = encode_coeffs_core(
            &self->ec, q, scan, offs, kh, kw, bwl, tx_class,
            eob_multi_size, eob_cdf, eob_extra_tab, eob_extra_w,
            dc_sign_cdf, base_cdf, base_w, base_eob_cdf, beob_w, br_cdf,
            br_w, eob, update);
        PyBuffer_Release(&qv);
        PyBuffer_Release(&sv);
        PyBuffer_Release(&ov);
        PyBuffer_Release(&eobv);
        PyBuffer_Release(&eobxv);
        PyBuffer_Release(&dcv);
        PyBuffer_Release(&basev);
        PyBuffer_Release(&beobv);
        PyBuffer_Release(&brv);
        return PyLong_FromLong(cul);
    }
}

/* ------------------------------------------------------------------ */
/* whole intra tile (fixed 16x16 leaf grid) — mirrors codec/syntax.py  */
/* ------------------------------------------------------------------ */

/* (above, left) partition context codes per subsize; we only ever
 * update with BLOCK_16X16 leaves => both 28 (PARTITION_CTX_LOOKUP[6]) */
#define PART_LEAF_CODE 28

/* INTRA_MODE_CONTEXT[mode] (entropy_coding.c intra mode ctx mapping) */
static const uint8_t intra_mode_ctx[13] =
    {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

/* partition enum values */
#define P_NONE 0
#define P_HORZ 1
#define P_VERT 2
#define P_SPLIT 3
#define P_HORZ_A 4
#define P_HORZ_B 5
#define P_VERT_A 6
#define P_VERT_B 7
#define P_HORZ_4 8
#define P_VERT_4 9

static int cdf_elem_prob(const uint16_t *icdf, int elem) {
    int prev = elem == 0 ? 32768 : icdf[elem - 1];
    return prev - icdf[elem];
}

static unsigned gather_horz_alike(const uint16_t *cdf) {
    /* nsyms == 10 (sizes 16..64) */
    int p0 = 32768;
    p0 -= cdf_elem_prob(cdf, P_HORZ);
    p0 -= cdf_elem_prob(cdf, P_SPLIT);
    p0 -= cdf_elem_prob(cdf, P_HORZ_A);
    p0 -= cdf_elem_prob(cdf, P_HORZ_B);
    p0 -= cdf_elem_prob(cdf, P_VERT_A);
    p0 -= cdf_elem_prob(cdf, P_HORZ_4);
    return (unsigned)(32768 - p0);
}

static unsigned gather_vert_alike(const uint16_t *cdf) {
    int p0 = 32768;
    p0 -= cdf_elem_prob(cdf, P_VERT);
    p0 -= cdf_elem_prob(cdf, P_SPLIT);
    p0 -= cdf_elem_prob(cdf, P_VERT_A);
    p0 -= cdf_elem_prob(cdf, P_VERT_B);
    p0 -= cdf_elem_prob(cdf, P_HORZ_A);
    p0 -= cdf_elem_prob(cdf, P_VERT_4);
    return (unsigned)(32768 - p0);
}

typedef struct {
    int mi_rows, mi_cols, gw;
    int tx_signal, update;
    /* decisions */
    const uint8_t *y_modes, *uv_modes, *tx_types;
    const int32_t *qy, *qu, *qv;
    const int16_t *scan16, *scan8;
    const int8_t *off16, *off8;
    /* cdfs (rows of width *_w incl. counter slot) */
    uint16_t *part; int part_w;
    uint16_t *kf_y; int kf_w;
    uint16_t *angle; int angle_w;
    uint16_t *uv; int uv_w;
    uint16_t *skip; int skip_w;
    uint16_t *exttx; int exttx_w;
    const uint8_t *exttx_ind;
    uint16_t *txb_skip_y, *txb_skip_c; int tskip_w;
    uint16_t *eob_y, *eob_c;
    uint16_t *eobx_y, *eobx_c; int eobx_y_w, eobx_c_w;
    uint16_t *dcs_y, *dcs_c; int dcs_y_w, dcs_c_w;
    uint16_t *base_y, *base_c; int base_y_w, base_c_w;
    uint16_t *beob_y, *beob_c; int beob_y_w, beob_c_w;
    uint16_t *br_y, *br_c; int br_y_w, br_c_w;
    /* context state */
    uint8_t *above_part, *left_part;
    uint8_t *mi_mode, *mi_skip, *mi_coded;  /* (mi_rows x mi_cols) */
    int32_t *acoeff[3], *lcoeff[3];
} TileCtx;

static int blk_eob(const int32_t *q, const int16_t *scan, int n) {
    int c;
    for (c = n - 1; c >= 0; c--)
        if (q[scan[c]]) return c + 1;
    return 0;
}

static void tile_encode_block(OdEc *e, TileCtx *t, int r4, int c4) {
    const int gw = t->gw;
    const int bi = (r4 >> 2) * gw + (c4 >> 2);
    const int32_t *qy = t->qy + bi * 256;
    const int32_t *qu = t->qu + bi * 64;
    const int32_t *qv = t->qv + bi * 64;
    const int mode = t->y_modes[bi];
    const int uv_mode = t->uv_modes[bi];
    const int tx_type = t->tx_types[bi];
    const int eob_y = blk_eob(qy, t->scan16, 256);
    const int eob_u = blk_eob(qu, t->scan8, 64);
    const int eob_v = blk_eob(qv, t->scan8, 64);
    const int skip = (eob_y == 0 && eob_u == 0 && eob_v == 0);
    const int mc = t->mi_cols, mr = t->mi_rows;
    int i;

    /* skip flag */
    {
        int above = (r4 > 0 && t->mi_coded[(r4 - 1) * mc + c4])
                        ? t->mi_skip[(r4 - 1) * mc + c4] : 0;
        int left = (c4 > 0 && t->mi_coded[r4 * mc + c4 - 1])
                       ? t->mi_skip[r4 * mc + c4 - 1] : 0;
        uint16_t *cdf = t->skip + (above + left) * t->skip_w;
        ec_encode_symbol(e, skip, cdf, 2);
        if (t->update) cdf_update(cdf, skip, 2);
    }
    /* kf y mode */
    {
        int am = (r4 > 0 && t->mi_coded[(r4 - 1) * mc + c4])
                     ? t->mi_mode[(r4 - 1) * mc + c4] : 0;
        int lm = (c4 > 0 && t->mi_coded[r4 * mc + c4 - 1])
                     ? t->mi_mode[r4 * mc + c4 - 1] : 0;
        uint16_t *cdf = t->kf_y
            + (intra_mode_ctx[am] * 5 + intra_mode_ctx[lm]) * t->kf_w;
        ec_encode_symbol(e, mode, cdf, 13);
        if (t->update) cdf_update(cdf, mode, 13);
    }
    if (mode >= 1 && mode <= 8) {  /* V_PRED..D67_PRED: angle delta 0 */
        uint16_t *cdf = t->angle + (mode - 1) * t->angle_w;
        ec_encode_symbol(e, 3, cdf, 7);
        if (t->update) cdf_update(cdf, 3, 7);
    }
    /* uv mode (cfl allowed at 16x16), cdf row selected by the Y mode */
    {
        uint16_t *cdf = t->uv + mode * t->uv_w;
        ec_encode_symbol(e, uv_mode, cdf, 14);
        if (t->update) cdf_update(cdf, uv_mode, 14);
    }
    if (uv_mode >= 1 && uv_mode <= 8) {
        uint16_t *cdf = t->angle + (uv_mode - 1) * t->angle_w;
        ec_encode_symbol(e, 3, cdf, 7);
        if (t->update) cdf_update(cdf, 3, 7);
    }

    /* mi state */
    for (i = 0; i < 4; i++) {
        memset(t->mi_mode + (r4 + i) * mc + c4, mode, 4);
        memset(t->mi_skip + (r4 + i) * mc + c4, skip, 4);
        memset(t->mi_coded + (r4 + i) * mc + c4, 1, 4);
    }
    (void)mr;

    if (skip) {
        int p;
        for (i = 0; i < 4; i++) {
            t->acoeff[0][c4 + i] = 0;
            t->lcoeff[0][r4 + i] = 0;
        }
        for (p = 1; p < 3; p++) {
            t->acoeff[p][c4 >> 1] = 0;
            t->acoeff[p][(c4 >> 1) + 1] = 0;
            t->lcoeff[p][r4 >> 1] = 0;
            t->lcoeff[p][(r4 >> 1) + 1] = 0;
        }
        return;
    }

    /* luma txb: skip ctx = 0 (bsize == tx), dc_sign from ctx arrays */
    {
        int dc = 0, j, cul;
        for (j = 0; j < 4; j++) {
            int v = t->acoeff[0][c4 + j] >> COEFF_CONTEXT_BITS;
            dc += v == 1 ? -1 : (v == 2 ? 1 : 0);
            v = t->lcoeff[0][r4 + j] >> COEFF_CONTEXT_BITS;
            dc += v == 1 ? -1 : (v == 2 ? 1 : 0);
        }
        {
            int dctx = dc > 0 ? 2 : (dc < 0 ? 1 : 0);
            uint16_t *cdf = t->txb_skip_y + 0 * t->tskip_w;
            ec_encode_symbol(e, eob_y == 0, cdf, 2);
            if (t->update) cdf_update(cdf, eob_y == 0, 2);
            /* luma may be all-zero while chroma has coefficients */
            if (eob_y == 0) {
                for (j = 0; j < 4; j++) {
                    t->acoeff[0][c4 + j] = 0;
                    t->lcoeff[0][r4 + j] = 0;
                }
            } else {
                if (t->tx_signal) {
                    uint16_t *xcdf = t->exttx + mode * t->exttx_w;
                    int ind = t->exttx_ind[tx_type];
                    ec_encode_symbol(e, ind, xcdf, 5);
                    if (t->update) cdf_update(xcdf, ind, 5);
                }
                cul = encode_coeffs_core(
                    e, qy, t->scan16, t->off16, 16, 16, 4, TX_CLASS_2D, 4,
                    t->eob_y, t->eobx_y, t->eobx_y_w,
                    t->dcs_y + dctx * t->dcs_y_w, t->base_y, t->base_y_w,
                    t->beob_y, t->beob_y_w, t->br_y, t->br_y_w, eob_y,
                    t->update);
                for (j = 0; j < 4; j++) {
                    t->acoeff[0][c4 + j] = cul;
                    t->lcoeff[0][r4 + j] = cul;
                }
            }
        }
    }
    /* chroma txbs (8x8 at half coords) */
    {
        int p;
        const int cr = r4 >> 1, cc4 = c4 >> 1;
        const int32_t *qs[2];
        qs[0] = qu;
        qs[1] = qv;
        for (p = 0; p < 2; p++) {
            int plane = p + 1;
            int eobp = p == 0 ? eob_u : eob_v;
            int ca = 0, cl = 0, dc = 0, j;
            for (j = 0; j < 2; j++) {
                int av = t->acoeff[plane][cc4 + j];
                int lv2 = t->lcoeff[plane][cr + j];
                if (av) ca = 1;
                if (lv2) cl = 1;
                {
                    int v = av >> COEFF_CONTEXT_BITS;
                    dc += v == 1 ? -1 : (v == 2 ? 1 : 0);
                    v = lv2 >> COEFF_CONTEXT_BITS;
                    dc += v == 1 ? -1 : (v == 2 ? 1 : 0);
                }
            }
            {
                int sctx = 7 + ca + cl;
                int dctx = dc > 0 ? 2 : (dc < 0 ? 1 : 0);
                uint16_t *cdf = t->txb_skip_c + sctx * t->tskip_w;
                ec_encode_symbol(e, eobp == 0, cdf, 2);
                if (t->update) cdf_update(cdf, eobp == 0, 2);
                if (eobp == 0) {
                    for (j = 0; j < 2; j++) {
                        t->acoeff[plane][cc4 + j] = 0;
                        t->lcoeff[plane][cr + j] = 0;
                    }
                } else {
                    int cul = encode_coeffs_core(
                        e, qs[p], t->scan8, t->off8, 8, 8, 3, TX_CLASS_2D,
                        2, t->eob_c, t->eobx_c, t->eobx_c_w,
                        t->dcs_c + dctx * t->dcs_c_w, t->base_c,
                        t->base_c_w, t->beob_c, t->beob_c_w, t->br_c,
                        t->br_c_w, eobp, t->update);
                    for (j = 0; j < 2; j++) {
                        t->acoeff[plane][cc4 + j] = cul;
                        t->lcoeff[plane][cr + j] = cul;
                    }
                }
            }
        }
    }
}

static void tile_encode_partition(OdEc *e, TileCtx *t, int r4, int c4,
                                  int size) {
    int w4 = size >> 2;
    int half = w4 >> 1;
    int has_rows, has_cols, part, bsl, ctx_id;
    if (r4 >= t->mi_rows || c4 >= t->mi_cols) return;
    has_rows = (r4 + half) < t->mi_rows;
    has_cols = (c4 + half) < t->mi_cols;
    part = size <= 16 ? P_NONE : P_SPLIT;
    bsl = size == 64 ? 3 : (size == 32 ? 2 : 1);
    ctx_id = ((t->left_part[r4] >> bsl) & 1) * 2
             + ((t->above_part[c4] >> bsl) & 1) + bsl * 4;
    {
        uint16_t *cdf = t->part + ctx_id * t->part_w;
        if (size == 16) {
            /* leaf: PARTITION_NONE coded with the full 10-symbol cdf */
            if (has_rows && has_cols) {
                ec_encode_symbol(e, P_NONE, cdf, 10);
                if (t->update) cdf_update(cdf, P_NONE, 10);
            } else if (has_cols) {
                ec_encode_bool(e, 0, gather_horz_alike(cdf));
            } else if (has_rows) {
                ec_encode_bool(e, 0, gather_vert_alike(cdf));
            }
            /* !has_rows && !has_cols => implied split; but 16 is leaf:
             * cannot happen on 16-aligned frames */
            tile_encode_block(e, t, r4, c4);
            t->above_part[c4] = PART_LEAF_CODE;
            t->above_part[c4 + 1] = PART_LEAF_CODE;
            t->above_part[c4 + 2] = PART_LEAF_CODE;
            t->above_part[c4 + 3] = PART_LEAF_CODE;
            t->left_part[r4] = PART_LEAF_CODE;
            t->left_part[r4 + 1] = PART_LEAF_CODE;
            t->left_part[r4 + 2] = PART_LEAF_CODE;
            t->left_part[r4 + 3] = PART_LEAF_CODE;
            return;
        }
        if (has_rows && has_cols) {
            ec_encode_symbol(e, P_SPLIT, cdf, 10);
            if (t->update) cdf_update(cdf, P_SPLIT, 10);
        } else if (has_cols) {
            ec_encode_bool(e, 1, gather_horz_alike(cdf));
        } else if (has_rows) {
            ec_encode_bool(e, 1, gather_vert_alike(cdf));
        }
        /* else implied split, no bits */
    }
    tile_encode_partition(e, t, r4, c4, size >> 1);
    tile_encode_partition(e, t, r4, c4 + half, size >> 1);
    tile_encode_partition(e, t, r4 + half, c4, size >> 1);
    tile_encode_partition(e, t, r4 + half, c4 + half, size >> 1);
}

#define GETBUF(obj, view, flags) \
    if (PyObject_GetBuffer(obj, &view, flags)) return NULL

static PyObject *Enc_encode_intra_tile(EncObj *self, PyObject *args) {
    int mi_rows, mi_cols, tx_signal, update;
    PyObject *dec_o, *scan_o, *cdf_o;
    if (!PyArg_ParseTuple(args, "iiiiOOO", &mi_rows, &mi_cols, &tx_signal,
                          &update, &dec_o, &scan_o, &cdf_o))
        return NULL;

    /* dec_o: (y_modes, uv_modes, tx_types, qy, qu, qv)
       scan_o: (scan16, off16, scan8, off8, exttx_ind)
       cdf_o: (part, kf_y, angle, uv, skip, exttx, txb_skip_y, txb_skip_c,
               eob_y, eob_c, eobx_y, eobx_c, dcs_y, dcs_c, base_y, base_c,
               beob_y, beob_c, br_y, br_c) */
    Py_buffer bufs[32];
    int nbuf = 0;
    TileCtx t;
    memset(&t, 0, sizeof(t));
    t.mi_rows = mi_rows;
    t.mi_cols = mi_cols;
    t.gw = (mi_cols + 3) >> 2;
    t.tx_signal = tx_signal;
    t.update = update;

#define GRAB(seq, idx, flags, ptr_field, ctype)                            \
    {                                                                      \
        PyObject *o = PySequence_GetItem(seq, idx);                        \
        if (!o) return NULL;                                               \
        if (PyObject_GetBuffer(o, &bufs[nbuf], flags)) {                   \
            Py_DECREF(o);                                                  \
            return NULL;                                                   \
        }                                                                  \
        Py_DECREF(o);                                                      \
        t.ptr_field = (ctype *)bufs[nbuf].buf;                             \
        nbuf++;                                                            \
    }

    GRAB(dec_o, 0, PyBUF_C_CONTIGUOUS, y_modes, const uint8_t);
    GRAB(dec_o, 1, PyBUF_C_CONTIGUOUS, uv_modes, const uint8_t);
    GRAB(dec_o, 2, PyBUF_C_CONTIGUOUS, tx_types, const uint8_t);
    GRAB(dec_o, 3, PyBUF_C_CONTIGUOUS, qy, const int32_t);
    GRAB(dec_o, 4, PyBUF_C_CONTIGUOUS, qu, const int32_t);
    GRAB(dec_o, 5, PyBUF_C_CONTIGUOUS, qv, const int32_t);
    GRAB(scan_o, 0, PyBUF_C_CONTIGUOUS, scan16, const int16_t);
    GRAB(scan_o, 1, PyBUF_C_CONTIGUOUS, off16, const int8_t);
    GRAB(scan_o, 2, PyBUF_C_CONTIGUOUS, scan8, const int16_t);
    GRAB(scan_o, 3, PyBUF_C_CONTIGUOUS, off8, const int8_t);
    GRAB(scan_o, 4, PyBUF_C_CONTIGUOUS, exttx_ind, const uint8_t);

#define WRITABLE (PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE)
#define LASTDIM (int)(bufs[nbuf - 1].shape[bufs[nbuf - 1].ndim - 1])
    GRAB(cdf_o, 0, WRITABLE, part, uint16_t);
    t.part_w = LASTDIM;
    GRAB(cdf_o, 1, WRITABLE, kf_y, uint16_t);
    t.kf_w = LASTDIM;
    GRAB(cdf_o, 2, WRITABLE, angle, uint16_t);
    t.angle_w = LASTDIM;
    GRAB(cdf_o, 3, WRITABLE, uv, uint16_t);
    t.uv_w = LASTDIM;
    GRAB(cdf_o, 4, WRITABLE, skip, uint16_t);
    t.skip_w = LASTDIM;
    GRAB(cdf_o, 5, WRITABLE, exttx, uint16_t);
    t.exttx_w = LASTDIM;
    GRAB(cdf_o, 6, WRITABLE, txb_skip_y, uint16_t);
    t.tskip_w = LASTDIM;
    GRAB(cdf_o, 7, WRITABLE, txb_skip_c, uint16_t);
    GRAB(cdf_o, 8, WRITABLE, eob_y, uint16_t);
    GRAB(cdf_o, 9, WRITABLE, eob_c, uint16_t);
    GRAB(cdf_o, 10, WRITABLE, eobx_y, uint16_t);
    t.eobx_y_w = LASTDIM;
    GRAB(cdf_o, 11, WRITABLE, eobx_c, uint16_t);
    t.eobx_c_w = LASTDIM;
    GRAB(cdf_o, 12, WRITABLE, dcs_y, uint16_t);
    t.dcs_y_w = LASTDIM;
    GRAB(cdf_o, 13, WRITABLE, dcs_c, uint16_t);
    t.dcs_c_w = LASTDIM;
    GRAB(cdf_o, 14, WRITABLE, base_y, uint16_t);
    t.base_y_w = LASTDIM;
    GRAB(cdf_o, 15, WRITABLE, base_c, uint16_t);
    t.base_c_w = LASTDIM;
    GRAB(cdf_o, 16, WRITABLE, beob_y, uint16_t);
    t.beob_y_w = LASTDIM;
    GRAB(cdf_o, 17, WRITABLE, beob_c, uint16_t);
    t.beob_c_w = LASTDIM;
    GRAB(cdf_o, 18, WRITABLE, br_y, uint16_t);
    t.br_y_w = LASTDIM;
    GRAB(cdf_o, 19, WRITABLE, br_c, uint16_t);
    t.br_c_w = LASTDIM;
#undef GRAB
#undef WRITABLE
#undef LASTDIM

    /* context state */
    t.above_part = (uint8_t *)calloc(mi_cols, 1);
    t.left_part = (uint8_t *)calloc(mi_rows, 1);
    t.mi_mode = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    t.mi_skip = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    t.mi_coded = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    {
        int p;
        for (p = 0; p < 3; p++) {
            int s = p ? 1 : 0;
            t.acoeff[p] = (int32_t *)calloc(((mi_cols + 1) >> s) + 2, 4);
            t.lcoeff[p] = (int32_t *)calloc(((mi_rows + 1) >> s) + 2, 4);
        }
    }

    {
        int sb_rows = (mi_rows + 15) >> 4;
        int sb_cols = (mi_cols + 15) >> 4;
        int sr, sc, p, i;
        OdEc *e = &self->ec;
        /* pure-C loop over a per-encoder context: release the GIL so
         * tile columns entropy-code in parallel Python threads (the
         * ec_process.c tile-parallel analog) */
        Py_BEGIN_ALLOW_THREADS
        for (sr = 0; sr < sb_rows; sr++) {
            memset(t.left_part, 0, mi_rows);
            for (p = 0; p < 3; p++) {
                int s = p ? 1 : 0;
                for (i = 0; i < ((mi_rows + 1) >> s) + 2; i++)
                    t.lcoeff[p][i] = 0;
            }
            for (sc = 0; sc < sb_cols; sc++)
                tile_encode_partition(e, &t, sr * 16, sc * 16, 64);
        }
        Py_END_ALLOW_THREADS
    }

    free(t.above_part);
    free(t.left_part);
    free(t.mi_mode);
    free(t.mi_skip);
    free(t.mi_coded);
    {
        int p;
        for (p = 0; p < 3; p++) {
            free(t.acoeff[p]);
            free(t.lcoeff[p]);
        }
    }
    {
        int i;
        for (i = 0; i < nbuf; i++) PyBuffer_Release(&bufs[i]);
    }
    Py_RETURN_NONE;
}

static PyMethodDef Enc_methods[] = {
    {"encode_symbol", (PyCFunction)Enc_encode_symbol, METH_VARARGS, NULL},
    {"encode_bool", (PyCFunction)Enc_encode_bool, METH_VARARGS, NULL},
    {"encode_literal", (PyCFunction)Enc_encode_literal, METH_VARARGS, NULL},
    {"encode_coeffs", (PyCFunction)Enc_encode_coeffs, METH_VARARGS, NULL},
    {"encode_intra_tile", (PyCFunction)Enc_encode_intra_tile, METH_VARARGS,
     NULL},
    {"done", (PyCFunction)Enc_done, METH_NOARGS, NULL},
    {"tell_bits", (PyCFunction)Enc_tell_bits, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL}};

static PyTypeObject EncType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ec_native.RangeEncoder",
    .tp_basicsize = sizeof(EncObj),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = Enc_new,
    .tp_dealloc = (destructor)Enc_dealloc,
    .tp_methods = Enc_methods,
};

static PyModuleDef ecmodule = {
    PyModuleDef_HEAD_INIT, "ec_native", NULL, -1, NULL};

PyMODINIT_FUNC PyInit_ec_native(void) {
    PyObject *m;
    if (PyType_Ready(&EncType) < 0)
        return NULL;
    m = PyModule_Create(&ecmodule);
    if (!m)
        return NULL;
    Py_INCREF(&EncType);
    PyModule_AddObject(m, "RangeEncoder", (PyObject *)&EncType);
    return m;
}
