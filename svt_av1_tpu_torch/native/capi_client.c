/* A C client of the shim's standalone layout (capi_standalone.h): the
 * counterpart of tools/test_capi.c, which needs the reference's
 * EbSvtAv1Enc.h.  It reads raw 8-bit I420 frames, encodes them through
 * the C ABI and writes the packets as an IVF file:
 *
 *   capi_client IN.yuv OUT.ivf WIDTH HEIGHT PRESET QP KEYINT LEVELS
 *
 * KEYINT is intra_period_length (-2: all intra), LEVELS
 * hierarchical_levels.  Steps: init_handle (its defaults checked), set
 * the configuration, init, stream_header, send_picture per frame, the
 * NULL-picture EOS, get_packet until the EOS flag, release each buffer,
 * deinit.  Exits 0 and prints "CAPI OK" on success, another code naming
 * the step that failed otherwise.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "capi_standalone.h"

static void put_le(unsigned char *p, uint64_t v, int n) {
    for (int i = 0; i < n; i++)
        p[i] = (unsigned char)(v >> (8 * i));
}

int main(int argc, char **argv) {
    if (argc != 9) {
        fprintf(stderr, "usage: %s IN.yuv OUT.ivf WIDTH HEIGHT PRESET QP "
                "KEYINT LEVELS\n", argv[0]);
        return 2;
    }
    uint32_t w = (uint32_t)atoi(argv[3]), ht = (uint32_t)atoi(argv[4]);
    size_t fsize = (size_t)w * ht + 2 * (size_t)((w + 1) / 2)
                   * ((ht + 1) / 2);
    FILE *in = fopen(argv[1], "rb");
    FILE *out = fopen(argv[2], "wb");
    if (!in || !out) return 20;

    void *h = NULL;
    EbSvtAv1EncConfigurationTpu cfg;
    memset(&cfg, 0xAA, sizeof(cfg));   /* the defaults must overwrite */
    if (svt_av1_enc_init_handle(&h, &cfg) != SVT_TORCH_ERROR_NONE) return 1;
    if (cfg.enc_mode < 0 || cfg.enc_mode > 13 || cfg.qp > 63
            || cfg.encoder_bit_depth != 8) return 10;
    cfg.source_width = w;
    cfg.source_height = ht;
    cfg.enc_mode = atoi(argv[5]);
    cfg.qp = (uint32_t)atoi(argv[6]);
    cfg.intra_period_length = atoi(argv[7]);
    cfg.hierarchical_levels = (uint32_t)atoi(argv[8]);
    if (svt_av1_enc_set_parameter(h, &cfg) != SVT_TORCH_ERROR_NONE) return 2;
    if (svt_av1_enc_init(h) != SVT_TORCH_ERROR_NONE) return 3;

    void *hdr = NULL;
    if (svt_av1_enc_stream_header(h, &hdr) != SVT_TORCH_ERROR_NONE || !hdr
            || ((EbBufferHeaderTypeTpu *)hdr)->n_filled_len < 4) return 12;
    printf("stream header %u bytes\n",
           ((EbBufferHeaderTypeTpu *)hdr)->n_filled_len);
    svt_av1_enc_stream_header_release(hdr);

    unsigned char ivf[32] = "DKIF";
    put_le(ivf + 4, 0, 2);
    put_le(ivf + 6, 32, 2);
    memcpy(ivf + 8, "AV01", 4);
    put_le(ivf + 12, w, 2);
    put_le(ivf + 14, ht, 2);
    put_le(ivf + 16, 30, 4);
    put_le(ivf + 20, 1, 4);
    put_le(ivf + 24, 0, 4);            /* frame count, patched at the end */
    put_le(ivf + 28, 0, 4);
    fwrite(ivf, 1, 32, out);

    uint8_t *buf = malloc(fsize);
    uint64_t pts = 0;
    while (fread(buf, 1, fsize, in) == fsize) {
        EbBufferHeaderTypeTpu pic = {buf, (uint32_t)fsize, pts++, 0};
        if (svt_av1_enc_send_picture(h, &pic) != SVT_TORCH_ERROR_NONE)
            return 4;
    }
    /* the standard flush: a NULL picture */
    if (svt_av1_enc_send_picture(h, NULL) != SVT_TORCH_ERROR_NONE) return 5;

    uint32_t count = 0;
    int saw_eos = 0;
    while (!saw_eos) {
        void *pkt = NULL;
        int32_t r = svt_av1_enc_get_packet(h, &pkt, 1);
        if (r == SVT_TORCH_NO_ERROR_EMPTY_QUEUE) break;
        if (r != SVT_TORCH_ERROR_NONE || !pkt) return 6;
        EbBufferHeaderTypeTpu *p = pkt;
        unsigned char fh[12];
        put_le(fh, p->n_filled_len, 4);
        put_le(fh + 4, p->pts, 8);
        fwrite(fh, 1, 12, out);
        fwrite(p->p_buffer, 1, p->n_filled_len, out);
        printf("packet %u bytes pts %llu flags %x\n", p->n_filled_len,
               (unsigned long long)p->pts, p->flags);
        saw_eos = (p->flags & SVT_TORCH_BUFFERFLAG_EOS) != 0;
        svt_av1_enc_release_out_buffer(&pkt);
        count++;
    }
    if (!count || !saw_eos) return 7;
    put_le(ivf, count, 4);
    fseek(out, 24, SEEK_SET);
    fwrite(ivf, 1, 4, out);
    fclose(out);
    fclose(in);
    free(buf);
    if (svt_av1_enc_deinit(h) != SVT_TORCH_ERROR_NONE) return 8;
    svt_av1_enc_deinit_handle(h);
    printf("version %s\nCAPI OK\n", svt_av1_get_version());
    return 0;
}
