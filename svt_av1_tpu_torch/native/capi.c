/*
 * EbSvtAv1Enc-compatible C ABI over the PyTorch/CUDA encoder.
 *
 * Exposes the reference library's public entry points
 * (Source/API/EbSvtAv1Enc.h:951-1061: svt_av1_enc_init_handle,
 * set_parameter, parse_parameter, init, stream_header, send_picture,
 * get_packet, release_out_buffer, deinit, deinit_handle, get_version)
 * so downstream integrations written against the C API (the
 * ffmpeg/gstreamer plugin role) can link against this library while
 * the encoding itself runs through the embedded Python/PyTorch pipeline
 * (svt_av1_tpu_torch.api.encoder).  The encoder runs on the current CUDA
 * device; the environment variable SVT_AV1_TORCH_DEVICE names another
 * (e.g. "cpu").  Unset and without CUDA, svt_av1_enc_init returns an
 * error: there is no fallback.
 *
 * ABI modes:
 *  - REAL ABI (capi_abi.h present, generated by tools/gen_capi_abi.py
 *    against the reference's installed headers): the caller-visible
 *    EbSvtAv1EncConfiguration / EbBufferHeaderType / EbSvtIOFormat
 *    layouts are the REFERENCE ones, accessed via probed offsets, so
 *    a plugin compiled against stock EbSvtAv1Enc.h works unmodified.
 *    Input pictures arrive as EbSvtIOFormat (per-plane pointers with
 *    pixel strides, 8-bit or 10-bit LE), output packets as real
 *    EbBufferHeaderType with pic_type/flags/pts/dts filled.
 *  - Standalone (no capi_abi.h): the compact structs of
 *    capi_standalone.h; same function surface, useful when the
 *    reference headers are absent (capi_client.c is its client).
 *
 * Build: svt_av1_tpu_torch/native/capi.py -> build/capi/libSvtAv1EncTorch.so
 * Independent implementation; EbSvtAv1Enc.h cited for the surface.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__has_include)
#if __has_include("capi_abi.h")
#include "capi_abi.h"
#endif
#endif

typedef int32_t EbErrorType;
#ifdef SVT_TPU_REAL_ABI
#define ERR_NONE 0
#define ERR_NOMEM ((EbErrorType)ABI_EB_ErrorInsufficientResources)
#define ERR_BADPARAM ((EbErrorType)ABI_EB_ErrorBadParameter)
#define ERR_EMPTY ((EbErrorType)ABI_EB_NoErrorEmptyQueue)
#define FLAG_EOS ((uint32_t)ABI_EB_BUFFERFLAG_EOS)
#else
#define ERR_NONE 0
#define ERR_NOMEM ((EbErrorType)0x80001000)
#define ERR_BADPARAM ((EbErrorType)0x80001005)
#define ERR_EMPTY ((EbErrorType)0x80002033)
#define FLAG_EOS 1u
#endif

/* ---- the subset of the configuration the pipeline consumes ---- */
typedef struct {
    uint32_t source_width;
    uint32_t source_height;
    uint32_t qp;               /* CRF 0..63 */
    int32_t  enc_mode;         /* preset M0..M13 */
    int32_t  intra_period_length;
    uint32_t hierarchical_levels;
    uint32_t rate_control_mode; /* 0 CRF, 1 VBR, 2 CBR */
    uint32_t target_bit_rate;
    uint32_t encoder_bit_depth;
    uint32_t frame_rate_numerator;
    uint32_t frame_rate_denominator;
    uint32_t tile_columns;
    uint32_t stat_report;
} TpuCfg;

typedef struct {
    PyObject *encoder;         /* svt_av1_tpu_torch.api.encoder.Encoder */
    TpuCfg cfg;
    uint64_t pts_in;
    int eos_delivered;
} TpuHandle;

#ifndef SVT_TPU_REAL_ABI
/* standalone-layout structs (legacy shim mode) */
#include "capi_standalone.h"
#define ABI_BUF_SIZEOF sizeof(EbBufferHeaderTypeTpu)
#endif

/* each returned packet owns a reference to its Python bytes object;
 * svt_av1_enc_release_out_buffer drops it (reference semantics: every
 * buffer stays valid until explicitly released).  The caller sees the
 * leading ABI_BUF_SIZEOF bytes laid out as EbBufferHeaderType. */
typedef struct {
    PyObject *owner;
} PacketTail;
#define PKT_ALLOC (ABI_BUF_SIZEOF + sizeof(PacketTail))
#define PKT_TAIL(b) ((PacketTail *)((char *)(b) + ABI_BUF_SIZEOF))

/* little-endian field access through probed offsets (REAL ABI) or
 * plain member access (standalone) */
static uint64_t rd_u(const void *base, size_t off, size_t sz) {
    uint64_t v = 0;
    memcpy(&v, (const char *)base + off, sz);
    return v;
}

static int64_t rd_i(const void *base, size_t off, size_t sz) {
    uint64_t v = rd_u(base, off, sz);
    if (sz < 8 && (v >> (8 * sz - 1)))
        v |= ~((1ULL << (8 * sz)) - 1);   /* sign-extend */
    return (int64_t)v;
}

static void wr_u(void *base, size_t off, size_t sz, uint64_t v) {
    memcpy((char *)base + off, &v, sz);
}

static void wr_p(void *base, size_t off, void *p) {
    memcpy((char *)base + off, &p, sizeof(void *));
}

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    return Py_IsInitialized() ? 0 : -1;
}

const char *svt_av1_get_version(void) { return "svt-av1-tpu-torch-0.1"; }

void svt_av1_print_version(void) {
    fprintf(stderr, "SVT-AV1-TPU-TORCH %s (PyTorch/CUDA pipeline)\n",
            svt_av1_get_version());
}

/* ---- config marshalling ---- */

static void cfg_defaults(TpuCfg *c) {
    /* reference defaults (enc_settings.c:911 role) */
    memset(c, 0, sizeof(*c));
    c->qp = 35;
    c->enc_mode = 10;
    c->intra_period_length = -2;
    c->hierarchical_levels = 0;
    c->rate_control_mode = 0;
    c->target_bit_rate = 2000000;
    c->encoder_bit_depth = 8;
    c->frame_rate_numerator = 60;
    c->frame_rate_denominator = 1;
    c->tile_columns = 0;
}

#ifdef SVT_TPU_REAL_ABI
#define CFG_RD_U(cfg, name) \
    ((uint64_t)rd_u(cfg, ABI_CFG_##name##_OFF, ABI_CFG_##name##_SZ))
#define CFG_RD_I(cfg, name) \
    (rd_i(cfg, ABI_CFG_##name##_OFF, ABI_CFG_##name##_SZ))
#define CFG_WR(cfg, name, v) \
    wr_u(cfg, ABI_CFG_##name##_OFF, ABI_CFG_##name##_SZ, (uint64_t)(v))

static void cfg_from_abi(TpuCfg *c, const void *cfg) {
    c->source_width = (uint32_t)CFG_RD_U(cfg, SOURCE_WIDTH);
    c->source_height = (uint32_t)CFG_RD_U(cfg, SOURCE_HEIGHT);
    c->qp = (uint32_t)CFG_RD_U(cfg, QP);
    c->enc_mode = (int32_t)CFG_RD_I(cfg, ENC_MODE);
    c->intra_period_length = (int32_t)CFG_RD_I(cfg, INTRA_PERIOD_LENGTH);
    c->hierarchical_levels = (uint32_t)CFG_RD_U(cfg, HIERARCHICAL_LEVELS);
    c->rate_control_mode = (uint32_t)CFG_RD_U(cfg, RATE_CONTROL_MODE);
    c->target_bit_rate = (uint32_t)CFG_RD_U(cfg, TARGET_BIT_RATE);
    c->encoder_bit_depth = (uint32_t)CFG_RD_U(cfg, ENCODER_BIT_DEPTH);
    c->frame_rate_numerator =
        (uint32_t)CFG_RD_U(cfg, FRAME_RATE_NUMERATOR);
    c->frame_rate_denominator =
        (uint32_t)CFG_RD_U(cfg, FRAME_RATE_DENOMINATOR);
    c->tile_columns = (uint32_t)CFG_RD_U(cfg, TILE_COLUMNS);
    c->stat_report = (uint32_t)CFG_RD_U(cfg, STAT_REPORT);
}

static void cfg_to_abi(const TpuCfg *c, void *cfg) {
    memset(cfg, 0, ABI_CFG_SIZEOF);
    CFG_WR(cfg, SOURCE_WIDTH, c->source_width);
    CFG_WR(cfg, SOURCE_HEIGHT, c->source_height);
    CFG_WR(cfg, QP, c->qp);
    CFG_WR(cfg, ENC_MODE, (uint64_t)(int64_t)c->enc_mode);
    CFG_WR(cfg, INTRA_PERIOD_LENGTH,
           (uint64_t)(int64_t)c->intra_period_length);
    CFG_WR(cfg, HIERARCHICAL_LEVELS, c->hierarchical_levels);
    CFG_WR(cfg, RATE_CONTROL_MODE, c->rate_control_mode);
    CFG_WR(cfg, TARGET_BIT_RATE, c->target_bit_rate);
    CFG_WR(cfg, ENCODER_BIT_DEPTH, c->encoder_bit_depth);
    CFG_WR(cfg, FRAME_RATE_NUMERATOR, c->frame_rate_numerator);
    CFG_WR(cfg, FRAME_RATE_DENOMINATOR, c->frame_rate_denominator);
    CFG_WR(cfg, TILE_COLUMNS, c->tile_columns);
    CFG_WR(cfg, LEVEL, 0);              /* auto */
    CFG_WR(cfg, PRED_STRUCTURE, 2);     /* random access */
    CFG_WR(cfg, ENABLE_DLF_FLAG, 1);
    CFG_WR(cfg, CDEF_LEVEL, -1);
    CFG_WR(cfg, ENABLE_RESTORATION_FILTERING, -1);
    CFG_WR(cfg, ENABLE_TF, 1);
    CFG_WR(cfg, SCENE_CHANGE_DETECTION, 0);
    CFG_WR(cfg, MAX_QP_ALLOWED, 63);
    CFG_WR(cfg, MIN_QP_ALLOWED, 1);
    CFG_WR(cfg, COLOR_PRIMARIES, 2);
    CFG_WR(cfg, TRANSFER_CHARACTERISTICS, 2);
    CFG_WR(cfg, MATRIX_COEFFICIENTS, 2);
}
#endif

EbErrorType svt_av1_enc_init_handle(void **handle, void *cfg) {
    if (!handle || !cfg)
        return ERR_BADPARAM;
    TpuHandle *h = calloc(1, sizeof(*h));
    if (!h)
        return ERR_NOMEM;
    cfg_defaults(&h->cfg);
#ifdef SVT_TPU_REAL_ABI
    cfg_to_abi(&h->cfg, cfg);
#else
    {
        EbSvtAv1EncConfigurationTpu *c = cfg;
        c->qp = h->cfg.qp;
        c->enc_mode = h->cfg.enc_mode;
        c->intra_period_length = h->cfg.intra_period_length;
        c->hierarchical_levels = h->cfg.hierarchical_levels;
        c->rate_control_mode = h->cfg.rate_control_mode;
        c->target_bit_rate = h->cfg.target_bit_rate;
        c->encoder_bit_depth = h->cfg.encoder_bit_depth;
    }
#endif
    *handle = h;
    return ERR_NONE;
}

EbErrorType svt_av1_enc_set_parameter(void *hv, void *cfg) {
    TpuHandle *h = hv;
    if (!h || !cfg)
        return ERR_BADPARAM;
#ifdef SVT_TPU_REAL_ABI
    cfg_from_abi(&h->cfg, cfg);
#else
    {
        EbSvtAv1EncConfigurationTpu *c = cfg;
        h->cfg.source_width = c->source_width;
        h->cfg.source_height = c->source_height;
        h->cfg.qp = c->qp;
        h->cfg.enc_mode = c->enc_mode;
        h->cfg.intra_period_length = c->intra_period_length;
        h->cfg.hierarchical_levels = c->hierarchical_levels;
        h->cfg.rate_control_mode = c->rate_control_mode;
        h->cfg.target_bit_rate = c->target_bit_rate;
        h->cfg.encoder_bit_depth = c->encoder_bit_depth;
    }
#endif
    return ERR_NONE;
}

/* single-parameter string interface (svt_av1_enc_parse_parameter):
 * the name set mirrors the reference's parse_parameter table for the
 * options the pipeline supports (enc_settings.c:1501 role) */
EbErrorType svt_av1_enc_parse_parameter(void *cfg, const char *name,
                                        const char *value) {
    if (!cfg || !name || !value)
        return ERR_BADPARAM;
    long v = strtol(value, NULL, 10);
#ifdef SVT_TPU_REAL_ABI
    if (!strcmp(name, "preset"))
        CFG_WR(cfg, ENC_MODE, (uint64_t)(int64_t)v);
    else if (!strcmp(name, "crf") || !strcmp(name, "qp"))
        CFG_WR(cfg, QP, (uint64_t)v);
    else if (!strcmp(name, "keyint"))
        CFG_WR(cfg, INTRA_PERIOD_LENGTH, (uint64_t)(int64_t)(v - 1));
    else if (!strcmp(name, "hierarchical-levels"))
        CFG_WR(cfg, HIERARCHICAL_LEVELS, (uint64_t)v);
    else if (!strcmp(name, "rc"))
        CFG_WR(cfg, RATE_CONTROL_MODE, (uint64_t)v);
    else if (!strcmp(name, "tbr"))
        CFG_WR(cfg, TARGET_BIT_RATE, (uint64_t)v * 1000);
    else if (!strcmp(name, "input-depth"))
        CFG_WR(cfg, ENCODER_BIT_DEPTH, (uint64_t)v);
    else if (!strcmp(name, "tile-columns"))
        CFG_WR(cfg, TILE_COLUMNS, (uint64_t)v);
    else
        return ERR_BADPARAM;
    return ERR_NONE;
#else
    (void)v;
    return ERR_BADPARAM;
#endif
}

EbErrorType svt_av1_enc_init(void *hv) {
    TpuHandle *h = hv;
    if (!h)
        return ERR_BADPARAM;
    if (ensure_python())
        return ERR_NOMEM;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule("svt_av1_tpu_torch.api.encoder");
    PyObject *cfgmod = PyImport_ImportModule("svt_av1_tpu_torch.api.config");
    EbErrorType err = ERR_NOMEM;
    if (mod && cfgmod) {
        PyObject *mkcfg = PyObject_GetAttrString(cfgmod, "EncoderConfig");
        PyObject *kw = Py_BuildValue(
            "{s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i,s:i}",
            "source_width", (int)h->cfg.source_width,
            "source_height", (int)h->cfg.source_height,
            "qp", (int)h->cfg.qp,
            "enc_mode", (int)h->cfg.enc_mode,
            "intra_period_length", (int)h->cfg.intra_period_length,
            "hierarchical_levels", (int)h->cfg.hierarchical_levels,
            "rate_control_mode", (int)h->cfg.rate_control_mode,
            "target_bit_rate", (int)h->cfg.target_bit_rate,
            "encoder_bit_depth", (int)h->cfg.encoder_bit_depth,
            "frame_rate_numerator",
            (int)(h->cfg.frame_rate_numerator
                  ? h->cfg.frame_rate_numerator : 60),
            "frame_rate_denominator",
            (int)(h->cfg.frame_rate_denominator
                  ? h->cfg.frame_rate_denominator : 1),
            "tile_columns", (int)h->cfg.tile_columns,
            "stat_report", (int)h->cfg.stat_report);
        PyObject *empty = PyTuple_New(0);
        PyObject *cfg = mkcfg ? PyObject_Call(mkcfg, empty, kw) : NULL;
        PyObject *enc_cls = PyObject_GetAttrString(mod, "Encoder");
        /* the device: SVT_AV1_TORCH_DEVICE, or None (the CUDA device) */
        const char *dev = getenv("SVT_AV1_TORCH_DEVICE");
        PyObject *devobj = dev && *dev ? PyUnicode_FromString(dev)
                                       : Py_NewRef(Py_None);
        if (cfg && enc_cls && devobj) {
            h->encoder = PyObject_CallFunctionObjArgs(enc_cls, cfg, devobj,
                                                      NULL);
            if (h->encoder)
                err = ERR_NONE;
        }
        Py_XDECREF(devobj);
        if (PyErr_Occurred())
            PyErr_Print();
        Py_XDECREF(cfg);
        Py_XDECREF(enc_cls);
        Py_XDECREF(mkcfg);
        Py_XDECREF(kw);
        Py_XDECREF(empty);
    }
    Py_XDECREF(mod);
    Py_XDECREF(cfgmod);
    PyGILState_Release(g);
    return err;
}

/* sequence header for container extradata (ffmpeg global_header) */
EbErrorType svt_av1_enc_stream_header(void *hv, void **out) {
    TpuHandle *h = hv;
    if (!h || !h->encoder || !out)
        return ERR_BADPARAM;
    *out = NULL;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *data = PyObject_CallMethod(h->encoder, "stream_header",
                                         NULL);
    EbErrorType err = ERR_BADPARAM;
    if (data && PyBytes_Check(data)) {
        char *b = calloc(1, PKT_ALLOC);
        wr_u(b, 0, 4, (uint32_t)ABI_BUF_SIZEOF);  /* .size */
#ifdef SVT_TPU_REAL_ABI
        wr_p(b, ABI_BUF_P_BUFFER_OFF, PyBytes_AsString(data));
        wr_u(b, ABI_BUF_N_FILLED_LEN_OFF, ABI_BUF_N_FILLED_LEN_SZ,
             (uint64_t)PyBytes_Size(data));
        wr_u(b, ABI_BUF_N_ALLOC_LEN_OFF, ABI_BUF_N_ALLOC_LEN_SZ,
             (uint64_t)PyBytes_Size(data));
#else
        {
            EbBufferHeaderTypeTpu *t = (EbBufferHeaderTypeTpu *)b;
            t->p_buffer = (uint8_t *)PyBytes_AsString(data);
            t->n_filled_len = (uint32_t)PyBytes_Size(data);
        }
#endif
        Py_INCREF(data);
        PKT_TAIL(b)->owner = data;
        *out = b;
        err = ERR_NONE;
    }
    if (PyErr_Occurred())
        PyErr_Print();
    Py_XDECREF(data);
    PyGILState_Release(g);
    return err;
}

EbErrorType svt_av1_enc_stream_header_release(void *hdr) {
    if (hdr) {
        PacketTail *t = PKT_TAIL(hdr);
        if (t->owner) {
            PyGILState_STATE g = PyGILState_Ensure();
            Py_CLEAR(t->owner);
            PyGILState_Release(g);
        }
        free(hdr);
    }
    return ERR_NONE;
}

/* build a (h, stride)->[:, :w] numpy view of one plane and return a
 * C-contiguous copy; stride is in PIXELS (the EbSvtIOFormat contract,
 * EbSvtAv1.h:149-158), elem 1 or 2 bytes (8 / 10-bit LE) */
static PyObject *plane_array(const uint8_t *ptr, uint32_t w, uint32_t ht,
                             uint32_t stride, int elem) {
    if (!stride)
        stride = w;
    PyObject *np = PyImport_ImportModule("numpy");
    if (!np)
        return NULL;
    PyObject *frombuf = PyObject_GetAttrString(np, "frombuffer");
    PyObject *raw = PyBytes_FromStringAndSize(
        (const char *)ptr, (Py_ssize_t)stride * ht * elem);
    PyObject *flat = PyObject_CallFunction(
        frombuf, "Os", raw, elem == 2 ? "uint16" : "uint8");
    PyObject *grid = flat ? PyObject_CallMethod(
        flat, "reshape", "(ii)", (int)ht, (int)stride) : NULL;
    PyObject *out = NULL;
    if (grid) {
        PyObject *sl = PySlice_New(NULL, NULL, NULL);
        PyObject *cols = PySlice_New(NULL,
                                     PyLong_FromLong((long)w), NULL);
        PyObject *key = PyTuple_Pack(2, sl, cols);
        PyObject *view = PyObject_GetItem(grid, key);
        if (view)
            out = PyObject_CallMethod(view, "copy", NULL);
        Py_XDECREF(view);
        Py_XDECREF(key);
        Py_XDECREF(cols);
        Py_XDECREF(sl);
    }
    Py_XDECREF(grid);
    Py_XDECREF(flat);
    Py_XDECREF(raw);
    Py_XDECREF(frombuf);
    Py_XDECREF(np);
    return out;
}

/* send one picture.  REAL ABI: pic->p_buffer is an EbSvtIOFormat with
 * per-plane pointers + pixel strides.  Standalone: contiguous I420. */
EbErrorType svt_av1_enc_send_picture(void *hv, void *pic) {
    TpuHandle *h = hv;
    if (!h || !h->encoder)
        return ERR_BADPARAM;
    PyGILState_STATE g = PyGILState_Ensure();
    uint32_t w = h->cfg.source_width, ht = h->cfg.source_height;
    uint32_t cw = (w + 1) / 2, cht = (ht + 1) / 2;
    int elem = h->cfg.encoder_bit_depth > 8 ? 2 : 1;
    const uint8_t *pbuf = NULL;
    uint32_t flags = 0;
    if (pic) {
#ifdef SVT_TPU_REAL_ABI
        pbuf = (const uint8_t *)(uintptr_t)rd_u(
            pic, ABI_BUF_P_BUFFER_OFF, ABI_BUF_P_BUFFER_SZ);
        flags = (uint32_t)rd_u(pic, ABI_BUF_FLAGS_OFF, ABI_BUF_FLAGS_SZ);
#else
        pbuf = ((EbBufferHeaderTypeTpu *)pic)->p_buffer;
        flags = ((EbBufferHeaderTypeTpu *)pic)->flags;
#endif
    }
    int eos = pic == NULL || !pbuf || (flags & FLAG_EOS);
    EbErrorType err = ERR_NONE;
    PyObject *res = NULL;
    if (pbuf) {
        PyObject *ya, *ua, *va;
#ifdef SVT_TPU_REAL_ABI
        const uint8_t *ly = (const uint8_t *)(uintptr_t)rd_u(
            pbuf, ABI_IO_LUMA_OFF, sizeof(void *));
        const uint8_t *lu = (const uint8_t *)(uintptr_t)rd_u(
            pbuf, ABI_IO_CB_OFF, sizeof(void *));
        const uint8_t *lv = (const uint8_t *)(uintptr_t)rd_u(
            pbuf, ABI_IO_CR_OFF, sizeof(void *));
        uint32_t ys = (uint32_t)rd_u(pbuf, ABI_IO_Y_STRIDE_OFF, 4);
        uint32_t cbs = (uint32_t)rd_u(pbuf, ABI_IO_CB_STRIDE_OFF, 4);
        uint32_t crs = (uint32_t)rd_u(pbuf, ABI_IO_CR_STRIDE_OFF, 4);
        ya = plane_array(ly, w, ht, ys, elem);
        ua = plane_array(lu, cw, cht, cbs, elem);
        va = plane_array(lv, cw, cht, crs, elem);
#else
        size_t ysz = (size_t)w * ht * elem;
        size_t csz = (size_t)cw * cht * elem;
        ya = plane_array(pbuf, w, ht, w, elem);
        ua = plane_array(pbuf + ysz, cw, cht, cw, elem);
        va = plane_array(pbuf + ysz + csz, cw, cht, cw, elem);
#endif
        if (ya && ua && va) {
            res = PyObject_CallMethod(h->encoder, "send_picture",
                                      "OOOi", ya, ua, va, eos);
        }
        Py_XDECREF(ya); Py_XDECREF(ua); Py_XDECREF(va);
        h->pts_in++;
    } else if (eos) {
        /* NULL-picture EOS (the standard flush pattern): drain the
         * pipeline so get_packet returns the tail frames */
        res = PyObject_CallMethod(h->encoder, "flush", NULL);
    }
    if (PyErr_Occurred()) {
        PyErr_Print();
        err = ERR_BADPARAM;
    }
    Py_XDECREF(res);
    PyGILState_Release(g);
    return err;
}

/* non-blocking packet fetch; EB_NoErrorEmptyQueue when nothing ready */
EbErrorType svt_av1_enc_get_packet(void *hv, void **out,
                                   uint8_t pic_send_done) {
    (void)pic_send_done;
    TpuHandle *h = hv;
    if (!h || !h->encoder || !out)
        return ERR_BADPARAM;
    *out = NULL;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *pkt = PyObject_CallMethod(h->encoder, "get_packet", NULL);
    EbErrorType err = ERR_EMPTY;
    if (pkt && pkt != Py_None) {
        PyObject *data = PyObject_GetAttrString(pkt, "data");
        PyObject *pts = PyObject_GetAttrString(pkt, "pts");
        PyObject *ftyp = PyObject_GetAttrString(pkt, "frame_type");
        PyObject *done = PyObject_GetAttrString(h->encoder, "done");
        if (data && PyBytes_Check(data)) {
            char *b = calloc(1, PKT_ALLOC);
            int64_t ptsv = pts ? PyLong_AsLongLong(pts) : 0;
            int is_key = ftyp && PyLong_AsLong(ftyp) == 0;
            int last = done == Py_True;
            uint32_t fl = last ? FLAG_EOS : 0;
            wr_u(b, 0, 4, (uint32_t)ABI_BUF_SIZEOF);
#ifdef SVT_TPU_REAL_ABI
            wr_p(b, ABI_BUF_P_BUFFER_OFF, PyBytes_AsString(data));
            wr_u(b, ABI_BUF_N_FILLED_LEN_OFF, ABI_BUF_N_FILLED_LEN_SZ,
                 (uint64_t)PyBytes_Size(data));
            wr_u(b, ABI_BUF_N_ALLOC_LEN_OFF, ABI_BUF_N_ALLOC_LEN_SZ,
                 (uint64_t)PyBytes_Size(data));
            wr_u(b, ABI_BUF_PTS_OFF, ABI_BUF_PTS_SZ, (uint64_t)ptsv);
            wr_u(b, ABI_BUF_DTS_OFF, ABI_BUF_DTS_SZ, (uint64_t)ptsv);
            wr_u(b, ABI_BUF_PIC_TYPE_OFF, ABI_BUF_PIC_TYPE_SZ,
                 is_key ? (uint64_t)ABI_EB_AV1_KEY_PICTURE
                        : (uint64_t)ABI_EB_AV1_INTER_PICTURE);
            wr_u(b, ABI_BUF_FLAGS_OFF, ABI_BUF_FLAGS_SZ, fl);
#else
            {
                EbBufferHeaderTypeTpu *t = (EbBufferHeaderTypeTpu *)b;
                t->p_buffer = (uint8_t *)PyBytes_AsString(data);
                t->n_filled_len = (uint32_t)PyBytes_Size(data);
                t->pts = (uint64_t)ptsv;
                t->flags = fl;
                (void)is_key;
            }
#endif
            Py_INCREF(data);
            PKT_TAIL(b)->owner = data;  /* buffer alive until release */
            *out = b;
            if (last)
                h->eos_delivered = 1;
            err = ERR_NONE;
        }
        Py_XDECREF(done);
        Py_XDECREF(ftyp);
        Py_XDECREF(data);
        Py_XDECREF(pts);
    }
    if (PyErr_Occurred()) {
        PyErr_Print();
        err = ERR_BADPARAM;
    }
    Py_XDECREF(pkt);
    PyGILState_Release(g);
    return err;
}

void svt_av1_enc_release_out_buffer(void **b) {
    if (b && *b) {
        PacketTail *t = PKT_TAIL(*b);
        if (t->owner) {
            PyGILState_STATE g = PyGILState_Ensure();
            Py_CLEAR(t->owner);
            PyGILState_Release(g);
        }
        free(*b);
        *b = NULL;
    }
}

EbErrorType svt_av1_enc_get_stream_info(void *hv, uint32_t id,
                                        void *info) {
    TpuHandle *h = hv;
    if (!h || !h->encoder || !info)
        return ERR_BADPARAM;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(h->encoder, "get_stream_info",
                                      "i", (int)id);
    EbErrorType err = r && r != Py_None ? ERR_NONE : ERR_BADPARAM;
    if (PyErr_Occurred()) {
        PyErr_Print();
        err = ERR_BADPARAM;
    }
    Py_XDECREF(r);
    PyGILState_Release(g);
    return err;
}

EbErrorType svt_av1_enc_deinit(void *hv) {
    TpuHandle *h = hv;
    if (!h)
        return ERR_BADPARAM;
    if (h->encoder) {
        PyGILState_STATE g = PyGILState_Ensure();
        Py_CLEAR(h->encoder);
        PyGILState_Release(g);
    }
    return ERR_NONE;
}

EbErrorType svt_av1_enc_deinit_handle(void *hv) {
    free(hv);
    return ERR_NONE;
}
