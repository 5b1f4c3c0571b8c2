/*
 * The standalone layout of the C ABI shim (capi.c built without the
 * reference's capi_abi.h): its compact configuration and buffer structs
 * and the entry points, for clients such as capi_client.c.
 */
#ifndef SVT_AV1_TORCH_CAPI_STANDALONE_H
#define SVT_AV1_TORCH_CAPI_STANDALONE_H
#include <stdint.h>

typedef struct {
    uint32_t source_width;
    uint32_t source_height;
    uint32_t qp;
    int32_t  enc_mode;
    int32_t  intra_period_length;
    uint32_t hierarchical_levels;
    uint32_t rate_control_mode;
    uint32_t target_bit_rate;
    uint32_t encoder_bit_depth;
} EbSvtAv1EncConfigurationTpu;

typedef struct {
    uint8_t *p_buffer;
    uint32_t n_filled_len;
    uint64_t pts;
    uint32_t flags;            /* bit 0: EOS */
} EbBufferHeaderTypeTpu;

#define SVT_TORCH_ERROR_NONE 0
#define SVT_TORCH_NO_ERROR_EMPTY_QUEUE ((int32_t)0x80002033)
#define SVT_TORCH_BUFFERFLAG_EOS 1u

const char *svt_av1_get_version(void);
int32_t svt_av1_enc_init_handle(void **handle, void *cfg);
int32_t svt_av1_enc_set_parameter(void *h, void *cfg);
int32_t svt_av1_enc_init(void *h);
int32_t svt_av1_enc_stream_header(void *h, void **out);
int32_t svt_av1_enc_stream_header_release(void *hdr);
int32_t svt_av1_enc_send_picture(void *h, void *pic);
int32_t svt_av1_enc_get_packet(void *h, void **out, uint8_t pic_send_done);
void svt_av1_enc_release_out_buffer(void **b);
int32_t svt_av1_enc_deinit(void *h);
int32_t svt_av1_enc_deinit_handle(void *h);
#endif
