/* Test oracle CLI over the reference's vendored fdk-aac.
 *
 * Built by tools/build_oracles.sh into .oracle_build/ (gitignored); gives
 * the conformance suite ground truth from the exact AAC library the
 * reference product ships (/root/reference/thirdparty/fdk-aac, used by
 * OpenHome/Media/Codec/AacFdk*.cpp).  Compiled from the read-only
 * reference tree, never copied into this repo.
 *
 * Usage:
 *   aac_oracle encode <in.raw16> <out.aac> <rate> <ch> <bitrate> [tp]
 *       in.raw16 = interleaved s16le; tp: 2=ADTS (default), 0=RAW
 *   aac_oracle decode <in.aac> <out.raw16> [tt]
 *       out.raw16 = interleaved s16le; tt: 2=ADTS (default), 0=RAW
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "aacenc_lib.h"
#include "aacdecoder_lib.h"

static long fsize(FILE *f) {
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    return n;
}

static int do_encode(const char *in, const char *out, int rate, int ch,
                     int bitrate, int tt, int aot)
{
    HANDLE_AACENCODER enc = NULL;
    if (aacEncOpen(&enc, 0, ch) != AACENC_OK) return 3;
    aacEncoder_SetParam(enc, AACENC_AOT, aot);     /* 2 = LC, 5 = HE-AAC */
    aacEncoder_SetParam(enc, AACENC_SAMPLERATE, rate);
    aacEncoder_SetParam(enc, AACENC_CHANNELMODE, ch == 1 ? MODE_1 : MODE_2);
    aacEncoder_SetParam(enc, AACENC_BITRATE, bitrate);
    aacEncoder_SetParam(enc, AACENC_TRANSMUX, tt);
    aacEncoder_SetParam(enc, AACENC_AFTERBURNER, 1);
    if (aacEncEncode(enc, NULL, NULL, NULL, NULL) != AACENC_OK) return 4;
    AACENC_InfoStruct info;
    aacEncInfo(enc, &info);

    FILE *fi = fopen(in, "rb"), *fo = fopen(out, "wb");
    if (!fi || !fo) return 2;
    long nbytes = fsize(fi);
    short *pcm = malloc(nbytes);
    fread(pcm, 1, nbytes, fi);
    fclose(fi);
    long total = nbytes / 2;
    long pos = 0;
    unsigned char obuf[20480];
    while (1) {
        int frame_in = info.frameLength * ch;
        int avail = (int)(total - pos);
        if (avail <= 0) break;
        int n = avail < frame_in ? avail : frame_in;
        AACENC_BufDesc ibd = {0}, obd = {0};
        AACENC_InArgs ia = {0};
        AACENC_OutArgs oa = {0};
        void *ibufs[1] = { pcm + pos };
        INT iid[1] = { IN_AUDIO_DATA };
        INT isz[1] = { n * 2 };
        INT iel[1] = { 2 };
        ibd.numBufs = 1; ibd.bufs = ibufs; ibd.bufferIdentifiers = iid;
        ibd.bufSizes = isz; ibd.bufElSizes = iel;
        void *obufs[1] = { obuf };
        INT oid[1] = { OUT_BITSTREAM_DATA };
        INT osz[1] = { sizeof(obuf) };
        INT oel[1] = { 1 };
        obd.numBufs = 1; obd.bufs = obufs; obd.bufferIdentifiers = oid;
        obd.bufSizes = osz; obd.bufElSizes = oel;
        ia.numInSamples = n;
        if (aacEncEncode(enc, &ibd, &obd, &ia, &oa) != AACENC_OK) break;
        fwrite(obuf, 1, oa.numOutBytes, fo);
        pos += ia.numInSamples;
    }
    /* flush */
    while (1) {
        AACENC_BufDesc ibd = {0}, obd = {0};
        AACENC_InArgs ia = {0};
        AACENC_OutArgs oa = {0};
        ia.numInSamples = -1;
        void *obufs[1] = { obuf };
        INT oid[1] = { OUT_BITSTREAM_DATA };
        INT osz[1] = { sizeof(obuf) };
        INT oel[1] = { 1 };
        obd.numBufs = 1; obd.bufs = obufs; obd.bufferIdentifiers = oid;
        obd.bufSizes = osz; obd.bufElSizes = oel;
        if (aacEncEncode(enc, &ibd, &obd, &ia, &oa) != AACENC_OK) break;
        if (oa.numOutBytes == 0) break;
        fwrite(obuf, 1, oa.numOutBytes, fo);
    }
    fclose(fo);
    aacEncClose(&enc);
    free(pcm);
    return 0;
}

static int do_decode(const char *in, const char *out, int tt)
{
    FILE *fi = fopen(in, "rb"), *fo = fopen(out, "wb");
    if (!fi || !fo) return 2;
    long nbytes = fsize(fi);
    unsigned char *bs = malloc(nbytes);
    fread(bs, 1, nbytes, fi);
    fclose(fi);
    HANDLE_AACDECODER dec = aacDecoder_Open(tt, 1);
    if (!dec) return 3;
    /* bypass the time-domain limiter/concealment delay so output is the
     * plain spec filterbank result (sample-aligned with encoder delay) */
    aacDecoder_SetParam(dec, AAC_PCM_LIMITER_ENABLE, 0);
    /* force the high-quality (complex-QMF) SBR chain for every channel
     * configuration: fdk silently falls back to the low-power real-QMF
     * chain for stereo (CAacDecoder_SyncQmfMode, aacdecoder.cpp:169-179)
     * which is a different, lower-fidelity algorithm; this framework
     * implements the HQ chain everywhere, so the oracle must too */
    aacDecoder_SetParam(dec, AAC_QMF_LOWPOWER, 0);
    static INT_PCM pcm[8 * 2048];
    UCHAR *ptr = bs;
    UINT left = (UINT)nbytes;
    while (left > 0) {
        UINT valid = left;
        if (aacDecoder_Fill(dec, &ptr, &left, &valid) != AAC_DEC_OK) break;
        ptr += left - valid;
        left = valid;
        while (1) {
            AAC_DECODER_ERROR e = aacDecoder_DecodeFrame(
                dec, pcm, sizeof(pcm) / sizeof(INT_PCM), 0);
            if (e == AAC_DEC_NOT_ENOUGH_BITS) break;
            if (e != AAC_DEC_OK) { break; }
            CStreamInfo *si = aacDecoder_GetStreamInfo(dec);
            fwrite(pcm, sizeof(INT_PCM), si->frameSize * si->numChannels, fo);
        }
    }
    fclose(fo);
    aacDecoder_Close(dec);
    free(bs);
    return 0;
}

int main(int argc, char **argv)
{
    if (argc >= 7 && !strcmp(argv[1], "encode"))
        return do_encode(argv[2], argv[3], atoi(argv[4]), atoi(argv[5]),
                         atoi(argv[6]), argc > 7 ? atoi(argv[7]) : 2,
                         argc > 8 ? atoi(argv[8]) : 2);
    if (argc >= 4 && !strcmp(argv[1], "decode"))
        return do_decode(argv[2], argv[3], argc > 4 ? atoi(argv[4]) : 2);
    fprintf(stderr, "usage: %s encode <in.raw16> <out.aac> <rate> <ch> [tp [aot]] "
            "<bitrate> [tp] | decode <in.aac> <out.raw16> [tt]\n", argv[0]);
    return 1;
}
