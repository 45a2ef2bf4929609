/* QMF filterbank kernel probe over the reference's vendored fdk-aac.
 *
 * The SBR decoder's QMF analysis/synthesis banks are linear and
 * 64-sample shift-invariant, so feeding unit impulses through fdk's own
 * implementation recovers the exact (modulated) kernels the framework's
 * matmul formulation needs — no hand-transcription of the rearranged
 * fixed-point prototype tables.  Reference for behaviour:
 * fdk-aac/libFDK/src/qmf.cpp, used by libSBRdec (the decoder the
 * reference product ships via OpenHome/Media/Codec/AacFdkBase.cpp).
 *
 *   sbr_probe ana <bands>    impulse responses of the analysis bank:
 *                            for each impulse position m in [0, 10*bands)
 *                            print real/imag of X[k] at the last slot
 *   sbr_probe syn <bands>    synthesis kernel: for each (band, re/im)
 *                            impulse print the next 11*bands output
 *                            samples
 *
 * Build (see tools/build_oracles.sh): links .oracle_build fdk objects.
 */

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "qmf.h"

static void run_ana(int bands) {
    const int poly = 5;
    const int span = 2 * poly * bands;            /* filter memory */
    const int nslots = 2 * poly + 2;
    /* the final slot's analysis window covers the last `span` samples */
    for (int m = 0; m < span; m++) {
        QMF_FILTER_BANK bank;
        memset(&bank, 0, sizeof(bank));
        FIXP_QAS states[1280];
        memset(states, 0, sizeof(states));
        if (qmfInitAnalysisFilterBank(&bank, states, nslots, bands, bands,
                                      bands, 0))
            exit(3);
        static FIXP_QMF workbuf[4096];
        static INT_PCM pcm[4096];
        FIXP_QMF re[64], im[64];
        memset(pcm, 0, sizeof(pcm));
        pcm[nslots * bands - span + m] = 16384;
        QMF_SCALE_FACTOR sf;
        memset(&sf, 0, sizeof(sf));
        /* feed slot by slot; print the final slot's bands */
        for (int l = 0; l < nslots; l++) {
            qmfAnalysisFilteringSlot(&bank, re, im, pcm + l * bands, 1,
                                     workbuf);
        }
        printf("%d", m);
        for (int k = 0; k < bands; k++)
            printf(" %d %d", (int)re[k], (int)im[k]);
        printf("\n");
    }
}

static void run_syn(int bands) {
    const int nslots = 12;
    for (int k = 0; k < bands; k++) {
        for (int part = 0; part < 2; part++) {
            QMF_FILTER_BANK bank;
            memset(&bank, 0, sizeof(bank));
            static FIXP_QSS states[4096];
            memset(states, 0, sizeof(states));
            if (qmfInitSynthesisFilterBank(&bank, states, nslots, bands,
                                          bands, bands, 0))
                exit(3);
            static FIXP_QMF workbuf[8192];
            static INT_PCM out[64 * 16];
            FIXP_QMF re[64], im[64];
            printf("%d %d", k, part);
            for (int l = 0; l < nslots; l++) {
                memset(re, 0, sizeof(re));
                memset(im, 0, sizeof(im));
                if (l == 0) {
                    /* FIXP_QMF is 32-bit here; large impulse so the
                       16-bit PCM output carries the kernel accurately */
                    if (part == 0) re[k] = 1 << 29;
                    else im[k] = 1 << 29;
                }
                qmfSynthesisFilteringSlot(&bank, re, im, 0, 0,
                                          out + l * bands, 1, workbuf);
            }
            for (int n = 0; n < nslots * bands; n++)
                printf(" %d", (int)out[n]);
            printf("\n");
        }
    }
}

/* Streaming analysis of a whole int16 mono PCM file (little-endian) on
 * fdk's own slot framing: prints one line per slot with re/im of every
 * band.  Lets host-side diagnostics compare two decoders' outputs in
 * fdk's exact QMF domain (slot grid anchored at sample 0). */
static void run_ana_stream(int bands, const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) exit(4);
    QMF_FILTER_BANK bank;
    memset(&bank, 0, sizeof(bank));
    static FIXP_QAS states[1280];
    memset(states, 0, sizeof(states));
    if (qmfInitAnalysisFilterBank(&bank, states, 2, bands, bands,
                                  bands, 0))
        exit(3);
    static FIXP_QMF workbuf[4096];
    static INT_PCM pcm[64];
    FIXP_QMF re[64], im[64];
    int slot = 0;
    for (;;) {
        size_t n = fread(pcm, sizeof(INT_PCM), (size_t)bands, f);
        if (n < (size_t)bands)
            break;
        qmfAnalysisFilteringSlot(&bank, re, im, pcm, 1, workbuf);
        printf("%d", slot++);
        for (int k = 0; k < bands; k++)
            printf(" %d %d", (int)re[k], (int)im[k]);
        printf("\n");
    }
    fclose(f);
}

int main(int argc, char **argv) {
    if (argc >= 3 && !strcmp(argv[1], "ana")) {
        run_ana(atoi(argv[2]));
        return 0;
    }
    if (argc >= 3 && !strcmp(argv[1], "syn")) {
        run_syn(atoi(argv[2]));
        return 0;
    }
    if (argc >= 4 && !strcmp(argv[1], "anas")) {
        run_ana_stream(atoi(argv[2]), argv[3]);
        return 0;
    }
    fprintf(stderr, "usage: %s ana|syn <bands> | anas <bands> <pcmfile>\n",
            argv[0]);
    return 1;
}
