// Fast host-side AAC-LC unpacker (C ABI, loaded via ctypes).
//
// Mirrors ohpipeline_jax/codecs/aac/bitstream.py (the correctness
// reference, validated against fdk-aac) for the hot path: ADTS framing +
// raw_data_block entropy decode into dense arrays.  Huffman LUTs are
// injected at init from the canonical ISO table data (tables.npz) — this
// file contains no codec tables.
//
// Output layout per group (R = F * C rows):
//   ics     [R][4]    int32: window_seq, window_shape, max_sfb, grouping
//   cb      [R][120]  int8 : codebook per (group, sfb), groups-major
//   sf      [R][120]  int32: scalefactor per (group, sfb)
//   quant   [R][1024] int32: transmission-order quantized coefficients
//   msmask  [F][120]  uint8: M/S flag per (group, sfb); 0xFF col0 = no CPE
//   tnsn    [R][8]    int32: TNS filter count per window
//   tnsp    [R][8*3*3] int32: per filter (length, order, direction)
//   tnsc    [R][8*3*12] float: per filter lattice coefficients
//
// Build: g++ -O3 -shared -fPIC aac_unpack.cc -o libaacunpack.so

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t nbytes;
    size_t pos = 0;
    bool ok = true;

    // 64-bit big-endian window with bit `pos` as MSB; bits past EOF are 0
    // (matching the old peek()'s zero-padding semantics).
    inline uint64_t window() const {
        size_t byte = pos >> 3;
        uint64_t w;
        if (byte + 8 <= nbytes) {
            memcpy(&w, data + byte, 8);
            w = __builtin_bswap64(w);
        } else {
            w = 0;
            for (int i = 0; i < 8; i++)
                w = (w << 8) | (byte + (size_t)i < nbytes
                                    ? data[byte + i] : 0);
        }
        return w << (pos & 7);
    }

    inline uint32_t read(int nbits) {        // nbits in [0, 32]
        if (nbits == 0) return 0;
        if (pos + nbits > nbytes * 8) { ok = false; return 0; }
        uint32_t v = (uint32_t)(window() >> (64 - nbits));
        pos += nbits;
        return v;
    }

    inline uint32_t peek(int nbits) {
        return (uint32_t)(window() >> (64 - nbits));
    }

    inline void skip(int nbits) { pos += nbits; }
    inline void align_byte() { pos = (pos + 7) & ~(size_t)7; }
};

// ---- injected Huffman LUTs -------------------------------------------
// Each book is repacked at injection time into ONE uint32 table:
// entry = (row << 6) | code_len (0 = invalid) — a single load per
// codeword instead of separate lengths[]/rows[] lookups.  The
// scalefactor book (19-bit codes -> a 2 MB flat table) additionally
// gets a 10-bit first level that covers the short, high-probability
// codes so the hot path stays in L1/L2.
struct Lut {
    int maxlen = 0;
    const uint8_t* lengths = nullptr;   // [1<<maxlen]
    const int32_t* rows = nullptr;      // [1<<maxlen] -> row index
    const int8_t* vals = nullptr;       // [n][dim]
    int dim = 0;
    int is_unsigned = 0;
    uint32_t* packed = nullptr;         // [1<<maxlen] (row<<6)|len
};
Lut g_spec[12];          // 1..11
Lut g_scl;               // dim 1, vals int8? use int16 via rows->vals16
const int16_t* g_scl_vals = nullptr;
constexpr int SCL_FAST = 10;
uint32_t* g_scl_fast = nullptr;         // [1<<SCL_FAST], 0 = escape

// 8 groups x 15-sfb stride + 1 mask sentinel byte = 121; round to 128 so
// the M/S mask row (offset by 1) can never touch the next row.
const int SFB_SLOTS = 128;
int16_t g_sfb_long[13][52];
int16_t g_sfb_short[13][16];
int g_nsfb[13][2];

}  // namespace

extern "C" {

void aac_set_tables(int cb, int maxlen, const uint8_t* lengths,
                    const int32_t* rows, const int8_t* vals, int dim,
                    int is_unsigned) {
    Lut& l = (cb == 0) ? g_scl : g_spec[cb];
    l.maxlen = maxlen;
    l.lengths = lengths;
    l.rows = rows;
    l.vals = vals;
    l.dim = dim;
    l.is_unsigned = is_unsigned;
    size_t n = (size_t)1 << maxlen;
    delete[] l.packed;
    l.packed = new uint32_t[n];
    for (size_t w = 0; w < n; w++)
        l.packed[w] = lengths[w]
            ? (((uint32_t)rows[w]) << 6) | lengths[w] : 0;
    if (cb == 0) {
        delete[] g_scl_fast;
        g_scl_fast = new uint32_t[(size_t)1 << SCL_FAST];
        for (size_t w = 0; w < ((size_t)1 << SCL_FAST); w++) {
            // the first-level entry is valid only when the code fits
            // entirely inside SCL_FAST bits
            uint32_t e = l.packed[w << (maxlen - SCL_FAST)];
            g_scl_fast[w] = (e && (e & 63) <= SCL_FAST) ? e : 0;
        }
    }
}

void aac_set_scl_vals(const int16_t* vals) { g_scl_vals = vals; }

void aac_set_sfb(int rate_index, const int16_t* lng, int nl,
                 const int16_t* shrt, int ns) {
    memcpy(g_sfb_long[rate_index], lng, sizeof(int16_t) * (nl + 1));
    memcpy(g_sfb_short[rate_index], shrt, sizeof(int16_t) * (ns + 1));
    g_nsfb[rate_index][0] = nl;
    g_nsfb[rate_index][1] = ns;
}

// TNS synthesis filtering over dequantized spectra (all-pole lattice ->
// direct form), applied per flagged row.  Mirrors synthesis.py
// _apply_tns_arrays.
void aac_tns_group(double* specs, int nrows, const int32_t* ics,
                   const int32_t* tnsn, const int32_t* tnsp,
                   const float* tnsc, int rate_index) {
    for (int r = 0; r < nrows; r++) {
        const int32_t* tn = &tnsn[r * 8];
        bool any = false;
        for (int w = 0; w < 8; w++) any |= tn[w] != 0;
        if (!any) continue;
        bool shortw = ics[r * 4] == 2;
        const int16_t* offsets = shortw ? g_sfb_short[rate_index]
                                        : g_sfb_long[rate_index];
        int nbands = g_nsfb[rate_index][shortw ? 1 : 0];
        int nwin = shortw ? 8 : 1;
        double* spec = &specs[(int64_t)r * 1024];
        for (int w = 0; w < nwin; w++) {
            int base = shortw ? w * 128 : 0;
            int bottom = nbands;
            for (int f = 0; f < tn[w] && f < 3; f++) {
                const int32_t* p = &tnsp[(r * 24 + w * 3 + f) * 3];
                int length = p[0], order = p[1], dir = p[2];
                int top = bottom;
                bottom = top - length;
                if (bottom < 0) bottom = 0;
                if (order == 0) continue;
                int start = offsets[bottom < nbands ? bottom : nbands];
                int end = offsets[top < nbands ? top : nbands];
                int lim = shortw ? 128 : 1024;
                if (end > lim) end = lim;
                if (end <= start) continue;
                // lattice -> direct form
                double a[16] = {0};
                int alen = 0;
                const float* k = &tnsc[(int64_t)(r * 24 + w * 3 + f) * 12];
                for (int i = 0; i < order && i < 12; i++) {
                    double tmp[16];
                    for (int j = 0; j < alen; j++)
                        tmp[j] = a[j] + k[i] * a[alen - 1 - j];
                    for (int j = 0; j < alen; j++) a[j] = tmp[j];
                    a[alen++] = k[i];
                }
                double state[16] = {0};
                int n = end - start;
                for (int ii = 0; ii < n; ii++) {
                    int idx = dir ? (end - 1 - ii) : (start + ii);
                    double y = spec[base + idx];
                    for (int j = 0; j < alen; j++) y -= a[j] * state[j];
                    for (int j = alen - 1; j > 0; j--)
                        state[j] = state[j - 1];
                    state[0] = y;
                    spec[base + idx] = y;
                }
            }
        }
    }
}

}  // extern "C"

namespace {

inline int decode_scl(BitReader& br) {
    uint32_t w = br.peek(g_scl.maxlen);
    uint32_t e = g_scl_fast[w >> (g_scl.maxlen - SCL_FAST)];
    if (!e) {
        e = g_scl.packed[w];            // long code: 2 MB flat table
        if (!e) { br.ok = false; return 0; }
    }
    br.skip(e & 63);
    return g_scl_vals[e >> 6];
}

struct Ics {
    int seq = 0, shape = 0, max_sfb = 0, grouping = 0;
    int ngroups = 1;
    int group_wins[8];
    bool short_win() const { return seq == 2; }
};

bool parse_ics_info(BitReader& br, Ics& ics) {
    br.read(1);
    ics.seq = br.read(2);
    ics.shape = br.read(1);
    if (ics.short_win()) {
        ics.max_sfb = br.read(4);
        ics.grouping = br.read(7);
        ics.ngroups = 1;
        int counts[8] = {1, 0, 0, 0, 0, 0, 0, 0};
        int gi = 0;
        for (int b = 6; b >= 0; b--) {
            if ((ics.grouping >> b) & 1) counts[gi]++;
            else counts[++gi] = 1;
        }
        ics.ngroups = gi + 1;
        for (int i = 0; i <= gi; i++) ics.group_wins[i] = counts[i];
    } else {
        ics.max_sfb = br.read(6);
        if (br.read(1)) return false;   // MAIN prediction unsupported
        ics.ngroups = 1;
        ics.group_wins[0] = 1;
    }
    return true;
}

struct ChOut {
    int32_t* ics;
    int8_t* cb;
    int32_t* sf;
    int32_t* quant;
    int32_t* tnsn;
    int32_t* tnsp;
    float* tnsc;
};

bool parse_ics_stream(BitReader& br, int rate_index, bool common,
                      const Ics* shared, ChOut& out) {
    int global_gain = br.read(8);
    Ics ics;
    if (common && shared) ics = *shared;
    else if (!parse_ics_info(br, ics)) return false;
    // A crafted/corrupt frame can code max_sfb beyond the SFB table for
    // this rate; offsets[k+1] would then read garbage widths and the
    // spectral write below would index out of [0,1024).  Reject it.
    if (ics.max_sfb > g_nsfb[rate_index][ics.short_win() ? 1 : 0])
        return false;
    out.ics[0] = ics.seq;
    out.ics[1] = ics.shape;
    out.ics[2] = ics.max_sfb;
    out.ics[3] = ics.grouping;

    int bits = ics.short_win() ? 3 : 5;
    int esc = (1 << bits) - 1;
    memset(out.cb, 0, SFB_SLOTS);
    memset(out.sf, 0, SFB_SLOTS * 4);
    // section data
    for (int g = 0; g < ics.ngroups; g++) {
        int k = 0;
        while (k < ics.max_sfb) {
            int sect_cb = br.read(4);
            int len = 0, incr;
            do { incr = br.read(bits); len += incr; } while (incr == esc);
            if (k + len > ics.max_sfb || !br.ok) return false;
            for (int i = 0; i < len; i++)
                out.cb[g * 15 + k + i] = (int8_t)sect_cb;
            k += len;
        }
    }
    // scalefactors
    int sf_val = global_gain, is_pos = 0, noise = global_gain - 90;
    bool noise_seen = false;
    for (int g = 0; g < ics.ngroups; g++) {
        for (int k = 0; k < ics.max_sfb; k++) {
            int c = out.cb[g * 15 + k];
            int32_t* slot = &out.sf[g * 15 + k];
            if (c == 0) *slot = 0;
            else if (c == 14 || c == 15) {
                is_pos += decode_scl(br);
                *slot = is_pos;
            } else if (c == 13) {
                if (!noise_seen) { noise_seen = true; noise += (int)br.read(9) - 256; }
                else noise += decode_scl(br);
                *slot = noise;
            } else {
                sf_val += decode_scl(br);
                if (sf_val < 0 || sf_val > 255) return false;
                *slot = sf_val;
            }
        }
    }
    if (!br.ok) return false;
    // pulse
    if (br.read(1)) return false;      // pulse unsupported (rare)
    // tns
    memset(out.tnsn, 0, 8 * 4);
    if (br.read(1)) {
        int nwin = ics.short_win() ? 8 : 1;
        for (int w = 0; w < nwin; w++) {
            int n_filt = br.read(ics.short_win() ? 1 : 2);
            out.tnsn[w] = n_filt;
            int coef_res = 0;
            if (n_filt) coef_res = br.read(1);
            for (int f = 0; f < n_filt && f < 3; f++) {
                int length = br.read(ics.short_win() ? 4 : 6);
                int order = br.read(ics.short_win() ? 3 : 5);
                int dir = 0;
                int32_t* p = &out.tnsp[(w * 3 + f) * 3];
                float* cf = &out.tnsc[(w * 3 + f) * 12];
                if (order) {
                    dir = br.read(1);
                    int compress = br.read(1);
                    int cbits = (coef_res + 3) - compress;
                    double iqfac = (((1 << (coef_res + 2)) - 0.5))
                        / (M_PI / 2.0);
                    double iqfac_m = (((1 << (coef_res + 2)) + 0.5))
                        / (M_PI / 2.0);
                    for (int i = 0; i < order && i < 12; i++) {
                        int v = br.read(cbits);
                        int half = 1 << (cbits - 1);
                        if (v >= half) v -= (1 << cbits);
                        cf[i] = (float)sin(v / (v >= 0 ? iqfac : iqfac_m));
                    }
                }
                p[0] = length; p[1] = order; p[2] = dir;
            }
        }
    }
    if (br.read(1)) return false;      // gain control (SSR) unsupported
    // spectral data
    memset(out.quant, 0, 1024 * 4);
    const int16_t* offsets = ics.short_win() ? g_sfb_short[rate_index]
                                             : g_sfb_long[rate_index];
    int pos = 0;
    for (int g = 0; g < ics.ngroups; g++) {
        int wins = ics.group_wins[g];
        int group_start = pos;
        for (int k = 0; k < ics.max_sfb; k++) {
            int c = out.cb[g * 15 + k];
            int width = offsets[k + 1] - offsets[k];
            int n = width * wins;
            if (n < 0 || pos + n > 1024) return false;  // defensive bound
            if (c == 0 || c == 12 || c >= 13) { pos += n; continue; }
            const Lut& lut = g_spec[c];
            const int dim = lut.dim, maxlen = lut.maxlen;
            const uint32_t* packed = lut.packed;
            const int8_t* vals = lut.vals;
            const int uns = lut.is_unsigned;
            const size_t endbit = br.nbytes * 8;
            for (int i = 0; i < n; i += dim) {
                // one 64-bit window serves the codeword lookup AND the
                // sign bits that follow it (len + signs <= 56 always)
                uint64_t w64 = br.window();
                uint32_t w = (uint32_t)(w64 >> (64 - maxlen));
                uint32_t e = packed[w];
                if (!e) return false;
                uint8_t len = (uint8_t)(e & 63);
                const int8_t* v = &vals[(e >> 6) * dim];
                int32_t vv[4];
                int adv = len;
                if (uns) {
                    int nz = 0;
                    for (int d = 0; d < dim; d++) nz += v[d] != 0;
                    uint32_t signs =
                        nz ? (uint32_t)((w64 << len) >> (64 - nz)) : 0;
                    adv += nz;
                    int bit = nz;
                    for (int d = 0; d < dim; d++) {
                        vv[d] = v[d];
                        if (v[d] != 0 && ((signs >> --bit) & 1))
                            vv[d] = -vv[d];
                    }
                } else {
                    for (int d = 0; d < dim; d++) vv[d] = v[d];
                }
                if (br.pos + (size_t)adv > endbit) return false;
                br.pos += adv;
                if (c == 11) {
                    for (int d = 0; d < dim; d++) {
                        if (vv[d] == 16 || vv[d] == -16) {
                            int e = 4;
                            while (br.read(1)) {
                                // ISO 14496-3 caps the escape prefix; a
                                // crafted run would otherwise drive the
                                // shift below into UB
                                if (++e > 21) return false;
                            }
                            int mag = (1 << e) | (int)br.read(e);
                            vv[d] = vv[d] > 0 ? mag : -mag;
                        }
                    }
                    if (!br.ok) return false;
                }
                for (int d = 0; d < dim && i + d < n; d++)
                    out.quant[pos + i + d] = vv[d];
            }
            pos += n;
        }
        pos = group_start + (ics.short_win() ? 128 * wins : 1024);
    }
    return br.ok;
}

}  // namespace

namespace {

// Parse up to max_frames ADTS frames.  Returns frames parsed; *bit_pos
// advances.  channels = expected channel count (frames with other counts
// are skipped).  Arrays sized for max_frames (per the layout above).
// When sbr_bytes is non-null, EXT_SBR_DATA(_CRC) fill payloads are
// captured per frame: sbr_bytes row stride SBR_STRIDE (big-endian bit
// packing, same layout the Python parser produces), sbr_nbits[f] the
// payload bit count (0 = no payload), sbr_crc[f] 1 for EXT_SBR_DATA_CRC.
constexpr int SBR_STRIDE = 272;   // max FIL payload 269 bytes

// Zigzag-nibble emission sinks for the fused parse (aac_parse_group_zz):
// the same planes/pools aac_prepare_rows_zz fills, bundled so
// parse_group_impl can emit each frame's wire rows right after the frame
// parses — while its dense quant row is still hot in cache — instead of
// a second cold pass over the whole group.
struct ZzArgs {
    int F;                       // pad target (rows F..nframes zero-fill)
    int32_t* prev_shape;
    uint8_t *q4, *sfb, *msb, *opx;
    uint8_t* ssf; int32_t* ssr; int32_t* ssf_count; int ssf_cap;
    uint8_t* tfi; float* tco; uint8_t* tdir; int32_t* trow;
    int32_t* tns_count; int tns_cap;
    int SC, col0; int64_t row_base;
    int32_t *esc_row, *esc_pos, *esc_val; int32_t* esc_count; int esc_cap;
    int32_t* special_rows; int32_t* n_special; int max_special;
};

// One channel's zz-wire emission (the per-channel body of
// aac_prepare_rows_zz, shared verbatim by the two-pass entry point and
// the fused parse).  f is the output frame slot, r = f*C + c the input
// row in the dense batch layout.  Returns 0 or the negative overflow
// codes documented on aac_prepare_rows_zz.
inline int zz_emit_channel(
        const int32_t* ics, const int8_t* cb, const int32_t* sf,
        const int32_t* quant, const int32_t* tnsn,
        const int32_t* tnsp, const float* tnsc,
        bool parsed, int rate_index, const ZzArgs& Z, int f, int c, int C) {
    int32_t* prev_shape = Z.prev_shape;
    int r = f * C + c;
    int64_t orow = (int64_t)f * Z.SC + Z.col0 + c;
    int seq = 0, shape = 0, max_sfb = 0, grouping = 0;
    if (parsed) {
        seq = ics[r * 4];
        shape = ics[r * 4 + 1];
        max_sfb = ics[r * 4 + 2];
        grouping = ics[r * 4 + 3];
    }
    bool shortw = seq == 2;
    Z.opx[orow] = (uint8_t)(seq * 4 + prev_shape[c] * 2 + shape);
    prev_shape[c] = shape;
    uint8_t* qrow = Z.q4 + orow * 512;
    uint8_t* brow = Z.sfb + orow * 64;
    memset(qrow, 0, 512);
    memset(brow, 0, 64);
    uint8_t* srow = nullptr;          // short rows: pooled sf bytes
    if (parsed && shortw) {
        if (*Z.ssf_count >= Z.ssf_cap) return -5;
        int j = (*Z.ssf_count)++;
        srow = Z.ssf + (int64_t)j * 1024;
        memset(srow, 0, 1024);
        Z.ssr[j] = (int32_t)(Z.row_base + orow);
    }
    if (!parsed) return 0;
    const int32_t* q = quant + (int64_t)r * 1024;
    const int8_t* cbr = cb + (int64_t)r * SFB_SLOTS;
    const int32_t* sfr = sf + (int64_t)r * SFB_SLOTS;
    const int16_t* offsets = shortw ? g_sfb_short[rate_index]
                                    : g_sfb_long[rate_index];
    // reconstruct the window grouping exactly as the parser did
    int group_wins[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    int ngroups = 1;
    if (shortw) {
        int gi = 0;
        for (int b = 6; b >= 0; b--) {
            if ((grouping >> b) & 1) group_wins[gi]++;
            else group_wins[++gi] = 1;
        }
        ngroups = gi + 1;
    }
    if (!shortw) {
        // long windows: grouped order == spectral order, so the
        // nibble emission is one flat scan with an 8-byte
        // zero-skip (spectra are sparse; uncoded bands are
        // already zero in q) — the band walk only sets sf bytes
        for (int k = 0; k < max_sfb && k < 64; k++) {
            int cbv = cbr[k];
            if (cbv >= 1 && cbv <= 11) {
                int32_t sv = sfr[k];
                brow[k] = (uint8_t)(sv < 0 ? 0
                                    : (sv > 255 ? 255 : sv));
            }
        }
        for (int j = 0; j < 1024; j += 2) {
            uint64_t two;
            memcpy(&two, q + j, 8);
            if (two == 0) continue;
            for (int d = 0; d < 2; d++) {
                int32_t v = q[j + d];
                if (v == 0) continue;
                int dst = j + d;
                uint32_t zz = (uint32_t)((v << 1) ^ (v >> 31));
                if (zz > 14) {
                    if (*Z.esc_count >= Z.esc_cap) return -4;
                    int e = (*Z.esc_count)++;
                    Z.esc_row[e] = (int32_t)(Z.row_base + orow);
                    Z.esc_pos[e] = dst;
                    Z.esc_val[e] = v;
                } else {
                    qrow[dst >> 1] |= (uint8_t)(
                        (dst & 1) ? (zz << 4) : zz);
                }
            }
        }
    } else {
        int pos = 0, win_base = 0;
        for (int g = 0; g < ngroups; g++) {
            int wins = group_wins[g];
            for (int k = 0; k < max_sfb; k++) {
                int width = offsets[k + 1] - offsets[k];
                int cbv = cbr[g * 15 + k];
                bool coded = cbv >= 1 && cbv <= 11;
                int32_t sv = sfr[g * 15 + k];
                uint8_t sb = (uint8_t)(sv < 0 ? 0 : (sv > 255 ? 255 : sv));
                for (int w = 0; w < wins; w++) {
                    int dbase = (win_base + w) * 128 + offsets[k];
                    for (int j = 0; j < width; j++) {
                        int dst = dbase + j;
                        if (coded) srow[dst] = sb;
                        int32_t v = q[pos + j];
                        if (v == 0) continue;
                        uint32_t zz = (uint32_t)((v << 1) ^ (v >> 31));
                        if (zz > 14) {
                            if (*Z.esc_count >= Z.esc_cap) return -4;
                            int e = (*Z.esc_count)++;
                            Z.esc_row[e] = (int32_t)(Z.row_base + orow);
                            Z.esc_pos[e] = dst;
                            Z.esc_val[e] = v;
                        } else {
                            qrow[dst >> 1] |= (uint8_t)(
                                (dst & 1) ? (zz << 4) : zz);
                        }
                    }
                    pos += width;
                }
            }
            win_base += wins;
            pos = win_base * 128;
        }
    }
    bool ch_special = false;
    for (int k = 0; k < 120; k++)
        if (cbr[k] >= 13) ch_special = true;
    const int32_t* tn = tnsn + (int64_t)r * 8;
    bool has_tns = false;
    for (int w = 0; w < 8; w++)
        if (tn[w]) { has_tns = true; break; }
    if (ch_special || (has_tns && Z.tns_cap == 0)) {
        // exotic rows — and, with no TNS pool, TNS rows too —
        // go to the host-prepared special/side path
        if (*Z.n_special >= Z.max_special) return -2;
        Z.special_rows[(*Z.n_special)++] = f * C + c;
    } else if (has_tns) {
        if (*Z.tns_count >= Z.tns_cap) return -6;
        int tj = (*Z.tns_count)++;
        uint8_t* firow = Z.tfi + (int64_t)tj * 1024;
        float* corow = Z.tco + (int64_t)tj * 24 * 12;
        uint8_t* drow = Z.tdir + (int64_t)tj * 24;
        memset(firow, 0, 1024);
        memset(corow, 0, sizeof(float) * 24 * 12);
        memset(drow, 0, 24);
        Z.trow[tj] = (int32_t)(Z.row_base + orow);
        const int16_t* toff = shortw ? g_sfb_short[rate_index]
                                     : g_sfb_long[rate_index];
        int nbands = g_nsfb[rate_index][shortw ? 1 : 0];
        int nwin = shortw ? 8 : 1;
        for (int w = 0; w < nwin; w++) {
            int base = shortw ? w * 128 : 0;
            int bottom = nbands;
            for (int fi = 0; fi < tn[w] && fi < 3; fi++) {
                const int32_t* p = &tnsp[(r * 24 + w * 3 + fi) * 3];
                int length = p[0], order = p[1], dir = p[2];
                int top = bottom;
                bottom = top - length;
                if (bottom < 0) bottom = 0;
                if (order == 0) continue;
                int start = toff[bottom < nbands ? bottom : nbands];
                int end = toff[top < nbands ? top : nbands];
                int lim = shortw ? 128 : 1024;
                if (end > lim) end = lim;
                if (end <= start) continue;
                // lattice -> direct form (same as aac_tns_group)
                double a[16] = {0};
                int alen = 0;
                const float* kk =
                    &tnsc[(int64_t)(r * 24 + w * 3 + fi) * 12];
                for (int i = 0; i < order && i < 12; i++) {
                    double tmp[16];
                    for (int j = 0; j < alen; j++)
                        tmp[j] = a[j] + kk[i] * a[alen - 1 - j];
                    for (int j = 0; j < alen; j++) a[j] = tmp[j];
                    a[alen++] = kk[i];
                }
                int slot = w * 3 + fi;
                for (int j = 0; j < alen; j++)
                    corow[slot * 12 + j] = (float)a[j];
                drow[slot] = (uint8_t)(dir ? 1 : 0);
                for (int i = base + start; i < base + end; i++)
                    firow[i] = (uint8_t)(slot + 1);
            }
        }
    }
    return 0;
}

// One pair's per-coefficient M/S bitmask row (left channel's layout;
// shared ics) — the per-pair body of aac_prepare_rows_zz.
inline void zz_emit_msrow(
        const int32_t* ics, const int8_t* cb, const uint8_t* msmask,
        bool parsed, int rate_index, const ZzArgs& Z, int f, int p, int C) {
    const int SP = Z.SC / 2;
    const int pair0 = Z.col0 / 2;
    uint8_t* mrow = Z.msb + ((int64_t)f * SP + pair0 + p) * 128;
    memset(mrow, 0, 128);
    if (!parsed) return;
    const uint8_t* ms = msmask + (int64_t)f * SFB_SLOTS;
    uint8_t flag = ms[0];
    if (flag != 1 && flag != 2) return;
    int rl = f * C + p * 2;
    int seq = ics[rl * 4];
    int max_sfb = ics[rl * 4 + 2];
    int grouping = ics[rl * 4 + 3];
    bool shortw = seq == 2;
    const int16_t* offsets = shortw ? g_sfb_short[rate_index]
                                    : g_sfb_long[rate_index];
    int group_wins[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    int ngroups = 1;
    if (shortw) {
        int gi = 0;
        for (int b = 6; b >= 0; b--) {
            if ((grouping >> b) & 1) group_wins[gi]++;
            else group_wins[++gi] = 1;
        }
        ngroups = gi + 1;
    }
    const int8_t* cbp = cb + ((int64_t)(f * C + p * 2 + 1))
        * SFB_SLOTS;
    int win_base = 0;
    for (int g = 0; g < ngroups; g++) {
        int wins = group_wins[g];
        for (int k = 0; k < max_sfb; k++) {
            bool on = (flag == 2) || ms[1 + g * 15 + k];
            if (cbp[g * 15 + k] >= 13) on = false;
            if (on) {
                for (int w = 0; w < wins; w++) {
                    int dbase = shortw
                        ? (win_base + w) * 128 + offsets[k]
                        : offsets[k];
                    for (int j = offsets[k]; j < offsets[k + 1]; j++) {
                        int dst = dbase + (j - offsets[k]);
                        mrow[dst >> 3] |= (uint8_t)(1u << (dst & 7));
                    }
                }
            }
        }
        win_base += wins;
    }
}

int parse_group_impl(const uint8_t* buf, int64_t nbytes, int64_t* byte_pos,
                     int max_frames, int channels,
                     int32_t* ics, int8_t* cb, int32_t* sf, int32_t* quant,
                     uint8_t* msmask, int32_t* tnsn, int32_t* tnsp,
                     float* tnsc, int32_t* rate_index_out,
                     uint8_t* sbr_bytes, int32_t* sbr_nbits,
                     int32_t* sbr_crc, const ZzArgs* zz = nullptr) {
    int64_t pos = *byte_pos;
    int nframes = 0;
    while (nframes < max_frames && pos + 7 <= nbytes) {
        if (buf[pos] != 0xFF || (buf[pos + 1] & 0xF6) != 0xF0) {
            pos++;                      // resync scan
            continue;
        }
        int protection_absent = buf[pos + 1] & 1;
        int rate_index = (buf[pos + 2] >> 2) & 0xF;
        int frame_bytes = ((buf[pos + 3] & 0x03) << 11)
            | (buf[pos + 4] << 3) | (buf[pos + 5] >> 5);
        int header_bytes = protection_absent ? 7 : 9;
        if (rate_index >= 13 || frame_bytes < header_bytes) { pos++; continue; }
        if (pos + frame_bytes > nbytes) break;
        *rate_index_out = rate_index;
        BitReader br{buf + pos + header_bytes,
                     (size_t)(frame_bytes - header_bytes)};
        int f = nframes;
        uint8_t* ms = &msmask[f * SFB_SLOTS];
        memset(ms, 0, SFB_SLOTS);
        ms[0] = 0xFF;                   // sentinel: no CPE mask
        if (sbr_bytes) { sbr_nbits[f] = 0; sbr_crc[f] = 0; }
        int ch_done = 0;
        bool bad = false;
        while (!bad) {
            int el = br.read(3);
            if (!br.ok) { bad = true; break; }
            if (el == 7) break;                       // END
            if (el == 0 || el == 3) {                 // SCE / LFE
                br.read(4);
                ChOut out{&ics[(f * channels + ch_done) * 4],
                          &cb[(f * channels + ch_done) * SFB_SLOTS],
                          &sf[(f * channels + ch_done) * SFB_SLOTS],
                          &quant[(int64_t)(f * channels + ch_done) * 1024],
                          &tnsn[(f * channels + ch_done) * 8],
                          &tnsp[(f * channels + ch_done) * 72],
                          &tnsc[(int64_t)(f * channels + ch_done) * 288]};
                if (ch_done >= channels
                    || !parse_ics_stream(br, rate_index, false, nullptr, out))
                    bad = true;
                else ch_done++;
            } else if (el == 1) {                     // CPE
                br.read(4);
                int common = br.read(1);
                Ics shared;
                if (common) {
                    if (!parse_ics_info(br, shared)
                        || shared.max_sfb >
                               g_nsfb[rate_index][shared.short_win() ? 1 : 0]) {
                        bad = true;
                        break;
                    }
                    int ms_present = br.read(2);
                    if (ms_present == 1) {
                        ms[0] = 1;
                        for (int g = 0; g < shared.ngroups; g++)
                            for (int k = 0; k < shared.max_sfb; k++)
                                ms[1 + g * 15 + k] = (uint8_t)br.read(1);
                    } else if (ms_present == 2) {
                        ms[0] = 2;
                    } else {
                        ms[0] = 0;
                    }
                } else {
                    ms[0] = 0;
                }
                for (int c = 0; c < 2; c++) {
                    if (ch_done >= channels) { bad = true; break; }
                    ChOut out{&ics[(f * channels + ch_done) * 4],
                              &cb[(f * channels + ch_done) * SFB_SLOTS],
                              &sf[(f * channels + ch_done) * SFB_SLOTS],
                              &quant[(int64_t)(f * channels + ch_done) * 1024],
                              &tnsn[(f * channels + ch_done) * 8],
                              &tnsp[(f * channels + ch_done) * 72],
                              &tnsc[(int64_t)(f * channels + ch_done) * 288]};
                    if (!parse_ics_stream(br, rate_index, common != 0,
                                          common ? &shared : nullptr, out)) {
                        bad = true;
                        break;
                    }
                    ch_done++;
                }
            } else if (el == 4) {                     // DSE
                br.read(4);
                int align = br.read(1);
                int cnt = br.read(8);
                if (cnt == 255) cnt += br.read(8);
                if (align) br.align_byte();
                for (int i = 0; i < cnt; i++) br.read(8);
            } else if (el == 6) {                     // FIL
                int cnt = br.read(4);
                if (cnt == 15) cnt += br.read(8) - 1;
                if (cnt > 0 && sbr_bytes) {
                    int ext_type = br.read(4);
                    int nbits = cnt * 8 - 4;
                    if (ext_type == 13 || ext_type == 14) {
                        uint8_t* dst = &sbr_bytes[(int64_t)f * SBR_STRIDE];
                        int nby = nbits >> 3, rem = nbits & 7;
                        for (int i = 0; i < nby; i++)
                            dst[i] = (uint8_t)br.read(8);
                        if (rem)
                            dst[nby] = (uint8_t)(br.read(rem) << (8 - rem));
                        sbr_nbits[f] = nbits;
                        sbr_crc[f] = ext_type == 14;
                    } else {
                        for (int i = 0; i < nbits; i += 8)
                            br.read(i + 8 <= nbits ? 8 : nbits - i);
                    }
                } else {
                    for (int i = 0; i < cnt; i++) br.read(8);
                }
            } else {
                bad = true;                           // CCE/PCE unsupported
            }
        }
        pos += frame_bytes;
        if (!bad && ch_done == channels) {
            if (zz) {
                // fused zz emission: the frame's dense rows (quant, cb,
                // sf) are still cache-hot — emit its wire rows now
                // instead of re-reading the whole group in a second pass
                int rc = 0;
                for (int c = 0; c < channels && !rc; c++)
                    rc = zz_emit_channel(ics, cb, sf, quant, tnsn,
                                         tnsp, tnsc, true, rate_index,
                                         *zz, nframes, c, channels);
                for (int p = 0; !rc && p < channels / 2; p++)
                    zz_emit_msrow(ics, cb, msmask, true, rate_index,
                                  *zz, nframes, p, channels);
                if (rc) { *byte_pos = pos; return rc; }
            }
            nframes++;
        }
        // bad frames are skipped (counted as lost), mirroring the Python
    }
    if (zz) {
        // pad rows past the last parsed frame, exactly as the two-pass
        // aac_prepare_rows_zz does for f >= nframes (zero rows, opx
        // continuing the prev_shape chain with seq = shape = 0)
        for (int f = nframes; f < zz->F; f++) {
            for (int c = 0; c < channels; c++)
                zz_emit_channel(ics, cb, sf, quant, tnsn, tnsp, tnsc,
                                false, 0, *zz, f, c, channels);
            for (int p = 0; p < channels / 2; p++)
                zz_emit_msrow(ics, cb, msmask, false, 0, *zz, f, p,
                              channels);
        }
    }
    *byte_pos = pos;
    return nframes;
}

}  // namespace

extern "C" {

int aac_parse_group(const uint8_t* buf, int64_t nbytes, int64_t* byte_pos,
                    int max_frames, int channels,
                    int32_t* ics, int8_t* cb, int32_t* sf, int32_t* quant,
                    uint8_t* msmask, int32_t* tnsn, int32_t* tnsp,
                    float* tnsc, int32_t* rate_index_out) {
    return parse_group_impl(buf, nbytes, byte_pos, max_frames, channels,
                            ics, cb, sf, quant, msmask, tnsn, tnsp, tnsc,
                            rate_index_out, nullptr, nullptr, nullptr);
}

// HE-AAC variant: also captures SBR fill payloads (see parse_group_impl).
int aac_parse_group_sbr(const uint8_t* buf, int64_t nbytes,
                        int64_t* byte_pos, int max_frames, int channels,
                        int32_t* ics, int8_t* cb, int32_t* sf,
                        int32_t* quant, uint8_t* msmask, int32_t* tnsn,
                        int32_t* tnsp, float* tnsc,
                        int32_t* rate_index_out, uint8_t* sbr_bytes,
                        int32_t* sbr_nbits, int32_t* sbr_crc) {
    return parse_group_impl(buf, nbytes, byte_pos, max_frames, channels,
                            ics, cb, sf, quant, msmask, tnsn, tnsp, tnsc,
                            rate_index_out, sbr_bytes, sbr_nbits, sbr_crc);
}

// Assemble device-dispatch inputs for one parsed group directly into the
// caller's stacked per-step slabs (the C equivalent of
// codecs/aac/prepare_device_group + the bench's numpy stacking; layouts
// must match synthesis.dequant_filterbank's docstring).
//
// Slab row addressing: row = f * SC + col0 + c for per-channel arrays,
// pair row = f * (SC/2) + pair0 + c/2 for ms_flag.  rows with f >= nframes
// are written as silence.  cfg_keys/cfg_count implement the shared config
// map: key = (ri<<20)|(seq<<16)|(grouping<<8)|max_sfb with seq/grouping
// forced 0 for long windows (matching the Python cfg_map keys).
//
// Returns 0 ok, -1 cfg table overflow, -2 special-row overflow (caller
// falls back to the Python path).
int aac_prepare_rows(const int32_t* ics, const int8_t* cb, const int32_t* sf,
                     const int32_t* quant, const uint8_t* msmask,
                     const int32_t* tnsn,
                     int nframes, int F, int C, int rate_index,
                     int32_t* prev_shape,
                     int16_t* quant16, int16_t* sf16, uint8_t* coded,
                     int32_t* cfg_idx, uint8_t* ms_flag, int32_t* opidx,
                     int SC, int col0,
                     int32_t* cfg_keys, int32_t* cfg_count, int max_cfg,
                     int32_t* special_frames, int32_t* n_special,
                     int max_special, int* overflow16) {
    *overflow16 = 0;
    *n_special = 0;
    const int pairs = C / 2;
    const int SP = SC / 2;
    const int pair0 = col0 / 2;
    for (int f = 0; f < F; f++) {
        bool parsed = f < nframes;
        bool frame_special = false;
        for (int c = 0; c < C; c++) {
            int r = f * C + c;                       // input row
            int64_t orow = (int64_t)f * SC + col0 + c;  // output row
            int seq = 0, shape = 0, max_sfb = 0, grouping = 0;
            if (parsed) {
                seq = ics[r * 4];
                shape = ics[r * 4 + 1];
                max_sfb = ics[r * 4 + 2];
                grouping = ics[r * 4 + 3];
            }
            bool shortw = seq == 2;
            int32_t key = ((int32_t)rate_index << 20)
                | ((shortw ? seq : 0) << 16)
                | ((shortw ? grouping : 0) << 8) | max_sfb;
            int ci = -1;
            for (int i = 0; i < *cfg_count; i++)
                if (cfg_keys[i] == key) { ci = i; break; }
            if (ci < 0) {
                if (*cfg_count >= max_cfg) return -1;
                ci = (*cfg_count)++;
                cfg_keys[ci] = key;
            }
            cfg_idx[orow] = ci;
            opidx[orow] = seq * 4 + prev_shape[c] * 2 + shape;
            prev_shape[c] = shape;
            int16_t* q16 = quant16 + orow * 1024;
            int16_t* s16 = sf16 + orow * 128;
            uint8_t* cd = coded + orow * 128;
            if (!parsed) {
                memset(q16, 0, 1024 * 2);
                memset(s16, 0, 128 * 2);
                memset(cd, 0, 128);
                continue;
            }
            const int32_t* q = quant + (int64_t)r * 1024;
            for (int i = 0; i < 1024; i++) {
                int32_t v = q[i];
                if (v < -32768 || v > 32767) {
                    *overflow16 = 1;
                    v = v < 0 ? -32768 : 32767;
                }
                q16[i] = (int16_t)v;
            }
            const int8_t* cbr = cb + (int64_t)r * SFB_SLOTS;
            const int32_t* sfr = sf + (int64_t)r * SFB_SLOTS;
            bool any_exotic = false;
            for (int k = 0; k < 120; k++) {
                int32_t s = sfr[k];
                s16[k] = (int16_t)(s < -32768 ? -32768
                                              : (s > 32767 ? 32767 : s));
                cd[k] = (cbr[k] >= 1 && cbr[k] <= 11);
                if (cbr[k] >= 13) any_exotic = true;
            }
            memset(s16 + 120, 0, 8 * 2);
            memset(cd + 120, 0, 8);
            if (any_exotic) frame_special = true;
            const int32_t* tn = tnsn + (int64_t)r * 8;
            for (int w = 0; w < 8; w++)
                if (tn[w]) { frame_special = true; break; }
        }
        // M/S flags per pair (the parser emits one mask per frame; CPE
        // channel pairs are (0,1), (2,3), ...)
        for (int p = 0; p < pairs; p++) {
            uint8_t* mrow = ms_flag + ((int64_t)f * SP + pair0 + p) * 128;
            memset(mrow, 0, 128);
            if (f >= nframes) continue;
            const uint8_t* ms = msmask + (int64_t)f * SFB_SLOTS;
            uint8_t flag = ms[0];
            if (flag == 2) {
                memset(mrow, 1, 120);
            } else if (flag == 1) {
                for (int k = 0; k < 120; k++) mrow[k] = ms[1 + k] != 0;
            }
            // exclude intensity/noise bands on the pair's right channel
            const int8_t* cbp = cb + ((int64_t)(f * C + p * 2 + 1))
                * SFB_SLOTS;
            for (int k = 0; k < 120; k++)
                if (cbp[k] >= 13) mrow[k] = 0;
        }
        if (frame_special) {
            if (*n_special >= max_special) return -2;
            special_frames[(*n_special)++] = f;
        }
    }
    return 0;
}

// Sparse variant of aac_prepare_rows for the host->device wire: instead of
// the dense (1024,) int16 quant row it emits
//   mask  [row][128] uint8  bit (7-(i&7)) of byte i>>3 set where q[i] != 0
//   vals  [row][vcap] int8  nonzero values in position order (rank order)
//   escape triples (row, pos, val) for |q| >= 128 (val8 holds a clipped
//   placeholder; the device overlay replaces it)
// and sf as uint8 gains for CODED slots only (others 0, so the device can
// use implicit coded = spec != 0).  ~4x fewer wire bytes at 128 kbps.
//
// Returns 0 ok, -1 cfg overflow, -2 special overflow, -3 vals overflow,
// -4 escape overflow (callers fall back to the dense path).
int aac_prepare_rows_sparse(
        const int32_t* ics, const int8_t* cb, const int32_t* sf,
        const int32_t* quant, const uint8_t* msmask, const int32_t* tnsn,
        int nframes, int F, int C, int rate_index,
        int32_t* prev_shape,
        uint8_t* mask, int8_t* vals, int vcap,
        uint8_t* sf_u8, int32_t* cfg_idx, uint8_t* ms_flag, int32_t* opidx,
        int SC, int col0,
        int32_t* esc_row, int32_t* esc_pos, int32_t* esc_val,
        int32_t* esc_count, int esc_cap,
        int32_t* cfg_keys, int32_t* cfg_count, int max_cfg,
        int32_t* special_frames, int32_t* n_special, int max_special) {
    *n_special = 0;
    const int pairs = C / 2;
    const int SP = SC / 2;
    const int pair0 = col0 / 2;
    for (int f = 0; f < F; f++) {
        bool parsed = f < nframes;
        bool frame_special = false;
        for (int c = 0; c < C; c++) {
            int r = f * C + c;
            int64_t orow = (int64_t)f * SC + col0 + c;
            int seq = 0, shape = 0, max_sfb = 0, grouping = 0;
            if (parsed) {
                seq = ics[r * 4];
                shape = ics[r * 4 + 1];
                max_sfb = ics[r * 4 + 2];
                grouping = ics[r * 4 + 3];
            }
            bool shortw = seq == 2;
            int32_t key = ((int32_t)rate_index << 20)
                | ((shortw ? seq : 0) << 16)
                | ((shortw ? grouping : 0) << 8) | max_sfb;
            int ci = -1;
            for (int i = 0; i < *cfg_count; i++)
                if (cfg_keys[i] == key) { ci = i; break; }
            if (ci < 0) {
                if (*cfg_count >= max_cfg) return -1;
                ci = (*cfg_count)++;
                cfg_keys[ci] = key;
            }
            cfg_idx[orow] = ci;
            opidx[orow] = seq * 4 + prev_shape[c] * 2 + shape;
            prev_shape[c] = shape;
            uint8_t* mrow = mask + orow * 128;
            int8_t* vrow = vals + orow * vcap;
            uint8_t* srow = sf_u8 + orow * 128;
            memset(mrow, 0, 128);
            memset(srow, 0, 128);
            if (!parsed) { memset(vrow, 0, vcap); continue; }
            const int32_t* q = quant + (int64_t)r * 1024;
            int rank = 0;
            for (int i = 0; i < 1024; i++) {
                int32_t v = q[i];
                if (v == 0) continue;
                if (rank >= vcap) return -3;
                mrow[i >> 3] |= (uint8_t)(1u << (7 - (i & 7)));
                if (v < -128 || v > 127) {
                    if (*esc_count >= esc_cap) return -4;
                    int j = (*esc_count)++;
                    esc_row[j] = (int32_t)orow;
                    esc_pos[j] = i;
                    esc_val[j] = v;
                    vrow[rank++] = v < 0 ? -128 : 127;
                } else {
                    vrow[rank++] = (int8_t)v;
                }
            }
            memset(vrow + rank, 0, (size_t)(vcap - rank));
            const int8_t* cbr = cb + (int64_t)r * SFB_SLOTS;
            const int32_t* sfr = sf + (int64_t)r * SFB_SLOTS;
            bool any_exotic = false;
            for (int k = 0; k < 120; k++) {
                if (cbr[k] >= 1 && cbr[k] <= 11) {
                    int32_t sv = sfr[k];
                    srow[k] = (uint8_t)(sv < 0 ? 0 : (sv > 255 ? 255 : sv));
                }
                if (cbr[k] >= 13) any_exotic = true;
            }
            if (any_exotic) frame_special = true;
            const int32_t* tn = tnsn + (int64_t)r * 8;
            for (int w = 0; w < 8; w++)
                if (tn[w]) { frame_special = true; break; }
        }
        for (int p = 0; p < pairs; p++) {
            uint8_t* mrow = ms_flag + ((int64_t)f * SP + pair0 + p) * 128;
            memset(mrow, 0, 128);
            if (f >= nframes) continue;
            const uint8_t* ms = msmask + (int64_t)f * SFB_SLOTS;
            uint8_t flag = ms[0];
            if (flag == 2) {
                memset(mrow, 1, 120);
            } else if (flag == 1) {
                for (int k = 0; k < 120; k++) mrow[k] = ms[1 + k] != 0;
            }
            const int8_t* cbp = cb + ((int64_t)(f * C + p * 2 + 1))
                * SFB_SLOTS;
            for (int k = 0; k < 120; k++)
                if (cbp[k] >= 13) mrow[k] = 0;
        }
        if (frame_special) {
            if (*n_special >= max_special) return -2;
            special_frames[(*n_special)++] = f;
        }
    }
    return 0;
}

// Zigzag-nibble wire variant tuned for the compressing host->device link
// AND for gather-free device decode:
//   q4   [row][512]  uint8: zigzag nibbles of the quantized coefficients at
//        their *spectral* (dst) positions — the short-window deinterleave
//        runs here on the host so the device needs no permutation tables.
//        zz = (v<<1)^(v>>31); values with |v| > 7 pack as 0 plus an escape
//        triple (row+row_base, dst, v).  Coefficient i lives in byte i>>1
//        (even i = low nibble).
//   sfb  [row][64]   uint8: per-band scalefactor byte for LONG-window
//        rows (band k of the rate's long sfb table; 0 when uncoded) —
//        the device expands it per coefficient with one one-hot matmul.
//   ssf  short-window rows can't use the long band layout; their
//        per-coefficient scalefactor bytes go to a pool: ssf[j][1024]
//        uint8 + ssr[j] = row_base + row (count in *ssf_count, cap
//        ssf_cap), scattered over the expanded bytes on device.
//   msb  [pair][128] uint8: per-coefficient M/S bitmask (bit i&7 of byte
//        i>>3, LSB-first).
//   opx  [row] uint8 window-operator index (seq*4 + prev_shape*2 + shape).
//
// Exception spectra are flagged per (frame, channel): special_rows gets
// f*C + c entries for channels whose final spectrum the wire cannot
// represent (PNS noise / intensity right channels) — the host preps
// those few channels and the device overwrites their rows.
//
// TNS-only rows stay on the wire path: their synthesis filters go to a
// pooled conditioning plane the device applies as a masked scan along
// frequency (tfi: per-coefficient filter slot+1, u8[pool][1024];
// tco: direct-form coefficients f32[pool][24][12] converted from the
// transmitted lattice exactly as aac_tns_group does; tdir:
// u8[pool][24] downward flags; trow: flat device row).  A row that is
// both TNS-filtered and exotic (cb>=13) remains a special row.
//
// Returns 0 ok, -2 special-row overflow, -4 escape overflow,
// -5 short-sf pool overflow, -6 TNS pool overflow.
int aac_prepare_rows_zz(
        const int32_t* ics, const int8_t* cb, const int32_t* sf,
        const int32_t* quant, const uint8_t* msmask, const int32_t* tnsn,
        const int32_t* tnsp, const float* tnsc,
        int nframes, int F, int C, int rate_index,
        int32_t* prev_shape,
        uint8_t* q4, uint8_t* sfb, uint8_t* msb, uint8_t* opx,
        uint8_t* ssf, int32_t* ssr, int32_t* ssf_count, int ssf_cap,
        uint8_t* tfi, float* tco, uint8_t* tdir, int32_t* trow,
        int32_t* tns_count, int tns_cap,
        int SC, int col0, int64_t row_base,
        int32_t* esc_row, int32_t* esc_pos, int32_t* esc_val,
        int32_t* esc_count, int esc_cap,
        int32_t* special_rows, int32_t* n_special, int max_special) {
    *n_special = 0;
    const int pairs = C / 2;
    ZzArgs Z{F, prev_shape, q4, sfb, msb, opx,
             ssf, ssr, ssf_count, ssf_cap,
             tfi, tco, tdir, trow, tns_count, tns_cap,
             SC, col0, row_base,
             esc_row, esc_pos, esc_val, esc_count, esc_cap,
             special_rows, n_special, max_special};
    for (int f = 0; f < F; f++) {
        bool parsed = f < nframes;
        for (int c = 0; c < C; c++) {
            int rc = zz_emit_channel(ics, cb, sf, quant, tnsn, tnsp, tnsc,
                                     parsed, rate_index, Z, f, c, C);
            if (rc) return rc;
        }
        // per-coefficient M/S bitmask (left channel's layout; shared ics)
        for (int p = 0; p < pairs; p++)
            zz_emit_msrow(ics, cb, msmask, parsed, rate_index, Z, f, p, C);
    }
    return 0;
}

// Fused parse + zz emission: one call does aac_parse_group AND
// aac_prepare_rows_zz, emitting each frame's wire rows while its dense
// planes are cache-hot (the second cold pass over ~4 KB/row quant data
// was the dominant remaining host cost of the bench's AAC leg).  The
// dense batch planes are still fully written — callers use them for the
// special/side rows.  Returns nframes >= 0, or the negative overflow
// codes of aac_prepare_rows_zz.
int aac_parse_group_zz(
        const uint8_t* buf, int64_t nbytes, int64_t* byte_pos,
        int max_frames, int channels,
        int32_t* ics, int8_t* cb, int32_t* sf, int32_t* quant,
        uint8_t* msmask, int32_t* tnsn, int32_t* tnsp, float* tnsc,
        int32_t* rate_index_out,
        int32_t* prev_shape,
        uint8_t* q4, uint8_t* sfb, uint8_t* msb, uint8_t* opx,
        uint8_t* ssf, int32_t* ssr, int32_t* ssf_count, int ssf_cap,
        uint8_t* tfi, float* tco, uint8_t* tdir, int32_t* trow,
        int32_t* tns_count, int tns_cap,
        int SC, int col0, int64_t row_base,
        int32_t* esc_row, int32_t* esc_pos, int32_t* esc_val,
        int32_t* esc_count, int esc_cap,
        int32_t* special_rows, int32_t* n_special, int max_special) {
    *n_special = 0;
    ZzArgs Z{max_frames, prev_shape, q4, sfb, msb, opx,
             ssf, ssr, ssf_count, ssf_cap,
             tfi, tco, tdir, trow, tns_count, tns_cap,
             SC, col0, row_base,
             esc_row, esc_pos, esc_val, esc_count, esc_cap,
             special_rows, n_special, max_special};
    return parse_group_impl(buf, nbytes, byte_pos, max_frames, channels,
                            ics, cb, sf, quant, msmask, tnsn, tnsp, tnsc,
                            rate_index_out, nullptr, nullptr, nullptr, &Z);
}

}  // extern "C"
