/* Test oracle CLI over the reference's vendored flac-1.2.1 (libFLAC).
 *
 * Built by tools/build_oracles.sh into .oracle_build/ (gitignored); used by
 * the conformance suite to prove ohpipeline_jax's FLAC path is bit-exact
 * against the exact decoder the reference product ships
 * (/root/reference/thirdparty/flac-1.2.1, used by
 * OpenHome/Media/Codec/Flac.cpp).  This file is ours; the library is
 * compiled from the read-only reference tree and never copied into the
 * repo.
 *
 * Usage:
 *   flac_oracle decode <in.flac> <out.raw>   # raw = interleaved host int32
 *   flac_oracle encode <in.raw> <out.flac> <rate> <channels> <bits> <nsamples>
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "FLAC/stream_decoder.h"
#include "FLAC/stream_encoder.h"

static FILE *g_out;
static FLAC__StreamDecoderWriteStatus
write_cb(const FLAC__StreamDecoder *dec, const FLAC__Frame *frame,
         const FLAC__int32 *const buffer[], void *client)
{
    unsigned n = frame->header.blocksize, ch = frame->header.channels;
    (void)dec; (void)client;
    for (unsigned i = 0; i < n; i++)
        for (unsigned c = 0; c < ch; c++)
            fwrite(&buffer[c][i], sizeof(FLAC__int32), 1, g_out);
    return FLAC__STREAM_DECODER_WRITE_STATUS_CONTINUE;
}

static void err_cb(const FLAC__StreamDecoder *dec,
                   FLAC__StreamDecoderErrorStatus status, void *client)
{
    (void)dec; (void)client;
    fprintf(stderr, "decoder error: %d\n", (int)status);
}

static int do_decode(const char *in, const char *out)
{
    g_out = fopen(out, "wb");
    if (!g_out) return 2;
    FLAC__StreamDecoder *dec = FLAC__stream_decoder_new();
    if (FLAC__stream_decoder_init_file(dec, in, write_cb, NULL, err_cb, NULL)
        != FLAC__STREAM_DECODER_INIT_STATUS_OK)
        return 3;
    int ok = FLAC__stream_decoder_process_until_end_of_stream(dec);
    FLAC__stream_decoder_finish(dec);
    FLAC__stream_decoder_delete(dec);
    fclose(g_out);
    return ok ? 0 : 4;
}

static int do_encode(const char *in, const char *out, int rate, int ch,
                     int bits, long nsamples)
{
    FILE *f = fopen(in, "rb");
    if (!f) return 2;
    FLAC__int32 *buf = malloc((size_t)nsamples * ch * sizeof(FLAC__int32));
    if (fread(buf, sizeof(FLAC__int32), (size_t)nsamples * ch, f)
        != (size_t)nsamples * ch)
        return 5;
    fclose(f);
    FLAC__StreamEncoder *enc = FLAC__stream_encoder_new();
    FLAC__stream_encoder_set_channels(enc, ch);
    FLAC__stream_encoder_set_bits_per_sample(enc, bits);
    FLAC__stream_encoder_set_sample_rate(enc, rate);
    FLAC__stream_encoder_set_compression_level(enc, 5);
    FLAC__stream_encoder_set_total_samples_estimate(enc, nsamples);
    if (FLAC__stream_encoder_init_file(enc, out, NULL, NULL)
        != FLAC__STREAM_ENCODER_INIT_STATUS_OK)
        return 3;
    int ok = FLAC__stream_encoder_process_interleaved(enc, buf,
                                                      (unsigned)nsamples);
    FLAC__stream_encoder_finish(enc);
    FLAC__stream_encoder_delete(enc);
    free(buf);
    return ok ? 0 : 4;
}

int main(int argc, char **argv)
{
    if (argc >= 4 && !strcmp(argv[1], "decode"))
        return do_decode(argv[2], argv[3]);
    if (argc >= 8 && !strcmp(argv[1], "encode"))
        return do_encode(argv[2], argv[3], atoi(argv[4]), atoi(argv[5]),
                         atoi(argv[6]), atol(argv[7]));
    fprintf(stderr, "usage: %s decode <in.flac> <out.raw> | "
            "encode <in.raw> <out.flac> <rate> <ch> <bits> <n>\n", argv[0]);
    return 1;
}
