// Fast host-side FLAC frame unpacker (C ABI, loaded via ctypes).
//
// The host/device decode split (SURVEY.md §7.3) leaves bit-serial entropy
// decode on the host CPU; this is that hot loop.  It mirrors the Python
// reference implementation in ohpipeline_jax/codecs/flac/frames.py exactly
// (same output layout) and is validated against it in tests.  Behavioural
// parity target: flac-1.2.1 stream_decoder.c's frame read path as used by
// the reference's OpenHome/Media/Codec/Flac.cpp — written from the FLAC
// spec, not translated from libFLAC.
//
// Layout produced per group of frames (B = nframes * channels rows):
//   data   [B x stride] int32  warmup+residuals (row-major, stride = maxN)
//   coeffs [B x 32]     int32
//   shift/order/wasted [B] int32
//   assign/blocksize/sample_number [F] int32/int64
//
// Build: g++ -O3 -shared -fPIC flac_unpack.cc -o libflacunpack.so

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t nbytes;
    size_t pos;        // bits
    bool ok = true;

    // 64-bit big-endian window starting at the current bit: bit `pos` is
    // the MSB.  At least 56 bits are valid (unread bits past EOF read 0).
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

    inline uint64_t read(int nbits) {        // nbits in [0, 56]
        if (nbits == 0) return 0;
        if (pos + nbits > nbytes * 8) { ok = false; return 0; }
        uint64_t v = window() >> (64 - nbits);
        pos += nbits;
        return v;
    }

    inline int64_t read_signed(int nbits) {
        uint64_t v = read(nbits);
        if (v >> (nbits - 1)) return (int64_t)(v - (1ULL << nbits));
        return (int64_t)v;
    }

    inline int read_unary() {
        int count = 0;
        while (true) {
            if (pos >= nbytes * 8) { ok = false; return 0; }
            uint64_t w = window();
            if (w == 0) {                     // >=56 zero bits; keep going
                int valid = (int)(nbytes * 8 - pos);
                if (valid <= 56) { ok = false; return 0; }
                count += 56;
                pos += 56;
                continue;
            }
            int lead = __builtin_clzll(w);
            size_t remaining = nbytes * 8 - pos;
            if ((size_t)lead >= remaining) { ok = false; return 0; }
            count += lead;
            pos += lead + 1;
            return count;
        }
    }

    inline int64_t read_rice(int param) {
        // fast path: whole code (unary + param bits) inside one window
        uint64_t w = window();
        if (w != 0) {
            int lead = __builtin_clzll(w);
            if (lead + 1 + param <= 56) {
                size_t remaining = nbytes * 8 - pos;
                if ((size_t)(lead + 1 + param) <= remaining) {
                    uint64_t v = ((uint64_t)lead << param);
                    if (param)
                        v |= (w << (lead + 1)) >> (64 - param);
                    pos += lead + 1 + param;
                    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
                }
            }
        }
        int q = read_unary();
        uint64_t v = ((uint64_t)q << param) | read(param);
        return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
    }

    inline void align_byte() { pos = (pos + 7) & ~(size_t)7; }

    inline int64_t read_utf8() {
        uint64_t b0 = read(8);
        if (b0 < 0x80) return (int64_t)b0;
        int n = 0;
        uint64_t mask = 0x40;
        while (b0 & mask) { n++; mask >>= 1; }
        if (n == 0 || n >= 7) { ok = false; return -1; }
        uint64_t v = b0 & (mask - 1);
        for (int i = 0; i < n; i++) {
            uint64_t c = read(8);
            if ((c & 0xC0) != 0x80) { ok = false; return -1; }
            v = (v << 6) | (c & 0x3F);
        }
        return (int64_t)v;
    }
};

uint8_t crc8_buf(const uint8_t* d, size_t n) {
    uint8_t crc = 0;
    for (size_t i = 0; i < n; i++) {
        crc ^= d[i];
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07)
                               : (uint8_t)(crc << 1);
    }
    return crc;
}

// CRC-16 poly 0x8005 (FLAC frame CRC), slicing-by-8: ~5x the byte-wise
// table loop, which otherwise dominates frame parse time.
uint16_t crc16_tab[8][256];
bool crc16_init_done = false;
void crc16_init() {
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i << 8;
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x8000) ? ((crc << 1) ^ 0x8005) & 0xFFFF
                                 : (crc << 1) & 0xFFFF;
        crc16_tab[0][i] = (uint16_t)crc;
    }
    for (int k = 1; k < 8; k++)
        for (int i = 0; i < 256; i++) {
            uint16_t c = crc16_tab[k - 1][i];
            crc16_tab[k][i] = (uint16_t)((c << 8)
                                         ^ crc16_tab[0][(c >> 8) & 0xFF]);
        }
    crc16_init_done = true;
}
uint16_t crc16_buf(const uint8_t* d, size_t n) {
    if (!crc16_init_done) crc16_init();
    uint16_t crc = 0;
    while (n >= 8) {
        crc = (uint16_t)(crc16_tab[7][d[0] ^ (crc >> 8)]
                         ^ crc16_tab[6][d[1] ^ (crc & 0xFF)]
                         ^ crc16_tab[5][d[2]] ^ crc16_tab[4][d[3]]
                         ^ crc16_tab[3][d[4]] ^ crc16_tab[2][d[5]]
                         ^ crc16_tab[1][d[6]] ^ crc16_tab[0][d[7]]);
        d += 8;
        n -= 8;
    }
    for (size_t i = 0; i < n; i++)
        crc = (uint16_t)((crc << 8)
                         ^ crc16_tab[0][((crc >> 8) ^ d[i]) & 0xFF]);
    return crc;
}

const int kBlocksizeTable[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                 256, 512, 1024, 2048, 4096, 8192, 16384,
                                 32768};
const int kRateTable[16] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                            24000, 32000, 44100, 48000, 96000, -1, -2, -3,
                            -4};
const int kSampleSize[8] = {0, 8, 12, -1, 16, 20, 24, 32};
const int kFixedCoeffs[5][4] = {{0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
                                {3, -3, 1, 0}, {4, -6, 4, -1}};

struct FrameHeaderOut {
    int blocksize, rate, channels, assign, bps;
    int64_t sample_number;
};

// returns 0 ok, <0 error
int parse_frame_header(BitReader& br, int si_rate, int si_bps,
                       int si_max_blocksize, FrameHeaderOut* out) {
    size_t start_byte = br.pos >> 3;
    if (br.read(14) != 0x3FFE) return -1;
    br.read(1);
    int variable = (int)br.read(1);
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int assign = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    int64_t coded = br.read_utf8();
    if (!br.ok || coded < 0) return -2;
    int blocksize;
    if (bs_code == 0) return -3;
    else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
    else blocksize = kBlocksizeTable[bs_code];
    int rate;
    if (sr_code == 0) rate = si_rate;
    else if (sr_code == 12) rate = (int)br.read(8) * 1000;
    else if (sr_code == 13) rate = (int)br.read(16);
    else if (sr_code == 14) rate = (int)br.read(16) * 10;
    else if (sr_code == 15) return -4;
    else rate = kRateTable[sr_code];
    int channels;
    if (assign <= 7) channels = assign + 1;
    else if (assign <= 10) channels = 2;
    else return -5;
    int bps = (ss_code == 0) ? si_bps : kSampleSize[ss_code];
    if (bps <= 0) return -6;
    size_t end_byte = br.pos >> 3;
    uint64_t expect = br.read(8);
    if (!br.ok) return -7;
    if (crc8_buf(br.data + start_byte, end_byte - start_byte) != expect)
        return -8;
    out->blocksize = blocksize;
    out->rate = rate;
    out->channels = channels;
    out->assign = assign;
    out->bps = bps;
    out->sample_number = variable ? coded : coded * si_max_blocksize;
    return 0;
}

// ---- rice-wire unit sink ----------------------------------------------
//
// The rice-wire variant (flac_parse_group_rice) ships the *entropy-coded
// bytes themselves* to the device and decodes the rice codes there
// (codecs/flac/rice_jax.py), instead of expanding residuals into byte
// planes on the host.  The parser walks every codeword exactly as the
// plane variants do, but instead of storing sample bytes it emits
// fixed-size "units": up to 64 consecutive residuals sharing one rice
// parameter and a start bit cursor.  Aligned full units land in a dense
// grid (row x stride/64 slots -> the device reshapes its scan output
// straight into the residual plane); partial/unaligned units go to a
// small overflow list that the device scatters.  Codewords the device
// window cannot hold (quotient > 15 or quotient+1+k > 32 bits) become
// escape triples and split the unit around themselves.
struct UnitSink {
    int64_t base_bit;          // entry bit (byte aligned); cursors relative
    int slots;                 // stride / 64
    int32_t* gcur; int8_t* gk; // grid planes, row-local indexing
    int32_t* ocur; int8_t* okk; int8_t* omode; int8_t* ocnt;
    int32_t* orow; int32_t* opos;
    int32_t* ocount; int ocap;
    int32_t* cfrow; int32_t* cfval; int32_t* cfn;
    int32_t* cfcount; int cfcap;
    int32_t* esc_row; int32_t* esc_pos; int32_t* esc_val;
    int32_t* esc_count; int esc_cap;
    int64_t row0;              // global row base for overflow/escape rows
    int fail = 0;              // -9 esc, -10 unit, -11 cfill overflow

    // emit residuals [a, b) of (local) row r decoded from bit `bit`
    inline void unit(int mode, int k, int a, int b, int64_t bit, int64_t r) {
        int n = b - a;
        if (n <= 0 || fail) return;
        int32_t rel = (int32_t)(bit - base_bit);
        if (mode == 0 && n == 64 && (a & 63) == 0) {
            gcur[r * slots + (a >> 6)] = rel;
            gk[r * slots + (a >> 6)] = (int8_t)k;
            return;
        }
        if (*ocount >= ocap) { fail = -10; return; }
        int j = (*ocount)++;
        ocur[j] = rel;
        okk[j] = (int8_t)k;
        omode[j] = (int8_t)mode;
        ocnt[j] = (int8_t)n;
        orow[j] = (int32_t)(row0 + r);
        opos[j] = a;
    }

    inline void escape(int64_t r, int pos, int32_t v) {
        if (fail) return;
        if (*esc_count >= esc_cap) { fail = -9; return; }
        int j = (*esc_count)++;
        esc_row[j] = (int32_t)(row0 + r);
        esc_pos[j] = pos;
        esc_val[j] = v;
    }

    inline void cfill(int64_t r, int32_t v, int n) {
        if (fail) return;
        if (*cfcount >= cfcap) { fail = -11; return; }
        int j = (*cfcount)++;
        cfrow[j] = (int32_t)(row0 + r);
        cfval[j] = v;
        cfn[j] = n;
    }
};

int read_residuals(BitReader& br, int blocksize, int order, int32_t* out,
                   UnitSink* sink = nullptr, int64_t row = 0) {
    int method = (int)br.read(2);
    if (method > 1) return -1;
    int plen = 4 + method;
    int escape = (1 << plen) - 1;
    int porder = (int)br.read(4);
    int npart = 1 << porder;
    if (blocksize % npart || (blocksize >> porder) < order) return -2;
    int idx = order;
    for (int p = 0; p < npart; p++) {
        int n = (blocksize >> porder) - (p == 0 ? order : 0);
        int param = (int)br.read(plen);
        if (param == escape) {
            int raw = (int)br.read(5);
            if (raw) {
                int ustart = idx;
                int64_t ubit = (int64_t)br.pos;
                for (int i = 0; i < n; i++) {
                    int j = idx + i;
                    if (sink && (j & 63) == 0 && j > ustart) {
                        sink->unit(1, raw, ustart, j, ubit, row);
                        ustart = j;
                        ubit = (int64_t)br.pos;
                    }
                    out[j] = (int32_t)br.read_signed(raw);
                }
                if (sink) sink->unit(1, raw, ustart, idx + n, ubit, row);
            } else {
                memset(out + idx, 0, sizeof(int32_t) * n);
                // no bits; device residual plane defaults to zero
            }
        } else {
            int ustart = idx;
            int64_t ubit = (int64_t)br.pos;
            for (int i = 0; i < n; i++) {
                int j = idx + i;
                if (sink && (j & 63) == 0 && j > ustart) {
                    sink->unit(0, param, ustart, j, ubit, row);
                    ustart = j;
                    ubit = (int64_t)br.pos;
                }
                int32_t v = (int32_t)br.read_rice(param);
                out[j] = v;
                if (sink) {
                    uint32_t zz = ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
                    uint32_t q = zz >> param;
                    if (q > 15 || (int)q + 1 + param > 32) {
                        // device window can't hold it: close the unit
                        // before this codeword and escape the sample
                        sink->unit(0, param, ustart, j, ubit, row);
                        sink->escape(row, j, v);
                        ustart = j + 1;
                        ubit = (int64_t)br.pos;
                    }
                }
            }
            if (sink) sink->unit(0, param, ustart, idx + n, ubit, row);
        }
        idx += n;
        if (!br.ok) return -3;
    }
    return 0;
}

int parse_subframe(BitReader& br, int blocksize, int bps, int32_t* data,
                   int32_t* coeffs, int32_t* shift, int32_t* order,
                   int32_t* wasted, UnitSink* sink = nullptr,
                   int64_t row = 0) {
    if (br.read(1)) return -1;
    int stype = (int)br.read(6);
    int w = 0;
    if (br.read(1)) w = 1 + br.read_unary();
    if (!br.ok) return -2;
    if (w >= bps) return -9;   // wasted bits must leave >=1 sample bit
    bps -= w;
    *wasted = w;
    *shift = 0;
    *order = 0;
    if (stype == 0) {
        int32_t v = (int32_t)br.read_signed(bps);
        for (int i = 0; i < blocksize; i++) data[i] = v;
        if (sink) sink->cfill(row, v, blocksize);
        return br.ok ? 0 : -3;
    }
    if (stype == 1) {
        if (sink && bps > 32) return -11;  // device window holds 32 bits
        int ustart = 0;
        int64_t ubit = (int64_t)br.pos;
        for (int i = 0; i < blocksize; i++) {
            if (sink && (i & 63) == 0 && i > ustart) {
                sink->unit(1, bps, ustart, i, ubit, row);
                ustart = i;
                ubit = (int64_t)br.pos;
            }
            data[i] = (int32_t)br.read_signed(bps);
        }
        if (sink) sink->unit(1, bps, ustart, blocksize, ubit, row);
        return br.ok ? 0 : -3;
    }
    if (stype >= 8 && stype <= 12) {
        int o = stype & 7;
        if (o > blocksize) return -10;  // warmup may not exceed the frame
        for (int i = 0; i < o; i++)
            data[i] = (int32_t)br.read_signed(bps);
        for (int i = 0; i < o; i++) coeffs[i] = kFixedCoeffs[o][i];
        *order = o;
        int r = read_residuals(br, blocksize, o, data, sink, row);
        return (r == 0 && br.ok) ? 0 : -4;
    }
    if (stype >= 32) {
        int o = (stype & 31) + 1;
        if (o > blocksize) return -10;  // warmup may not exceed the frame
        for (int i = 0; i < o; i++)
            data[i] = (int32_t)br.read_signed(bps);
        int precision = (int)br.read(4) + 1;
        if (precision == 16) return -5;
        int sh = (int)br.read_signed(5);
        if (sh < 0) return -6;
        for (int i = 0; i < o; i++)
            coeffs[i] = (int32_t)br.read_signed(precision);
        *order = o;
        *shift = sh;
        int r = read_residuals(br, blocksize, o, data, sink, row);
        return (r == 0 && br.ok) ? 0 : -7;
    }
    return -8;
}

// Parse up to max_frames frames starting at *bit_pos.  Returns the number
// of frames parsed; updates *bit_pos.  status: 0 = ok/EOF-of-buffer,
// 1 = lost sync (bad frame skipped via resync), negative = corrupt.
// With a UnitSink, additionally emits rice-wire units (see above).
int parse_group_core(const uint8_t* buf, int64_t nbytes, int64_t* bit_pos,
                     int si_rate, int si_bps, int si_max_blocksize,
                     int channels, int max_frames, int64_t stride,
                     int check_crc16,
                     int32_t* data, int32_t* coeffs, int32_t* shift,
                     int32_t* order, int32_t* wasted, int32_t* assign,
                     int32_t* blocksize, int64_t* sample_number,
                     int* status, UnitSink* sink = nullptr) {
    BitReader br{buf, (size_t)nbytes, (size_t)*bit_pos};
    int nframes = 0;
    *status = 0;
    while (nframes < max_frames) {
        size_t frame_start = br.pos;
        if ((int64_t)br.pos + 16 > nbytes * 8) break;
        FrameHeaderOut h;
        int rc = parse_frame_header(br, si_rate, si_bps, si_max_blocksize, &h);
        if (rc != 0) {
            // resync: scan forward for a plausible header
            size_t scan = (frame_start >> 3) + 1;
            bool found = false;
            while (scan + 2 < (size_t)nbytes) {
                if (buf[scan] == 0xFF && (buf[scan + 1] & 0xFC) == 0xF8) {
                    BitReader probe{buf, (size_t)nbytes, scan * 8};
                    FrameHeaderOut ph;
                    if (parse_frame_header(probe, si_rate, si_bps,
                                           si_max_blocksize, &ph) == 0) {
                        br.pos = scan * 8;
                        br.ok = true;
                        found = true;
                        *status = 1;
                        break;
                    }
                }
                scan++;
            }
            if (!found) { br.pos = frame_start; break; }
            continue;
        }
        if (h.channels != channels || h.blocksize > stride) {
            br.pos = frame_start;
            break;
        }
        bool bad = false;
        int64_t b0 = (int64_t)nframes * channels;
        int32_t save_oc = 0, save_cc = 0, save_ec = 0;
        if (sink) {
            save_oc = *sink->ocount;
            save_cc = *sink->cfcount;
            save_ec = *sink->esc_count;
        }
        for (int c = 0; c < channels && !bad; c++) {
            int bps = h.bps;
            if ((h.assign == 8 && c == 1) || (h.assign == 9 && c == 0) ||
                (h.assign == 10 && c == 1))
                bps += 1;
            int64_t b = b0 + c;
            if (parse_subframe(br, h.blocksize, bps, data + b * stride,
                               coeffs + b * 32, shift + b, order + b,
                               wasted + b, sink, b) != 0)
                bad = true;
        }
        if (sink && sink->fail) { *status = sink->fail; break; }
        if (!bad) {
            br.align_byte();
            size_t end_byte = br.pos >> 3;
            uint64_t expect = br.read(16);
            if (!br.ok) { br.pos = frame_start; break; }
            if (check_crc16 &&
                crc16_buf(buf + (frame_start >> 3),
                          end_byte - (frame_start >> 3)) != expect)
                bad = true;
        }
        if (bad) {
            if (sink) {
                // roll back units/escapes/cfills of the dropped frame and
                // clear any grid slots its rows touched
                *sink->ocount = save_oc;
                *sink->cfcount = save_cc;
                *sink->esc_count = save_ec;
                memset(sink->gk + b0 * sink->slots, 0xFF,
                       (size_t)channels * sink->slots);
            }
            if (!br.ok) { br.pos = frame_start; break; }  // need more bytes
            br.pos = frame_start + 8;  // skip a byte; resync next loop
            *status = 1;
            continue;
        }
        assign[nframes] = h.assign;
        blocksize[nframes] = h.blocksize;
        sample_number[nframes] = h.sample_number;
        nframes++;
    }
    *bit_pos = (int64_t)br.pos;
    return nframes;
}

}  // namespace

extern "C" {

int flac_parse_group(const uint8_t* buf, int64_t nbytes, int64_t* bit_pos,
                     int si_rate, int si_bps, int si_max_blocksize,
                     int channels, int max_frames, int64_t stride,
                     int check_crc16,
                     int32_t* data, int32_t* coeffs, int32_t* shift,
                     int32_t* order, int32_t* wasted, int32_t* assign,
                     int32_t* blocksize, int64_t* sample_number,
                     int* status) {
    return parse_group_core(buf, nbytes, bit_pos, si_rate, si_bps,
                            si_max_blocksize, channels, max_frames, stride,
                            check_crc16, data, coeffs, shift, order, wasted,
                            assign, blocksize, sample_number, status);
}

// As flac_parse_group, but additionally narrows the residual/warmup data
// to int16 in `data16` (the common 16-bit-content case; halves the bytes
// shipped to the accelerator without a separate astype pass).  Sets
// *overflow when any value doesn't fit — callers then use `data` instead.
int flac_parse_group16(const uint8_t* buf, int64_t nbytes, int64_t* bit_pos,
                       int si_rate, int si_bps, int si_max_blocksize,
                       int channels, int max_frames, int64_t stride,
                       int check_crc16,
                       int32_t* data, int32_t* coeffs, int32_t* shift,
                       int32_t* order, int32_t* wasted, int32_t* assign,
                       int32_t* blocksize, int64_t* sample_number,
                       int* status, int16_t* data16, int* overflow) {
    int n = flac_parse_group(buf, nbytes, bit_pos, si_rate, si_bps,
                             si_max_blocksize, channels, max_frames, stride,
                             check_crc16, data, coeffs, shift, order, wasted,
                             assign, blocksize, sample_number, status);
    *overflow = 0;
    int64_t total = (int64_t)n * channels * stride;
    int64_t cap = (int64_t)max_frames * channels * stride;
    for (int64_t i = 0; i < total; i++) {
        int32_t v = data[i];
        if (v < -32768 || v > 32767) { *overflow = 1; break; }
        data16[i] = (int16_t)v;
    }
    if (*overflow) {
        // caller uses the int32 buffer; clear its unparsed tail (buffers
        // are reused across calls, stale rows must stay silent)
        memset(data + total, 0, (size_t)(cap - total) * sizeof(int32_t));
    } else {
        memset(data16 + total, 0, (size_t)(cap - total) * sizeof(int16_t));
    }
    return n;
}

// As flac_parse_group, but ships residuals as a 12-bit pack (two samples
// -> three bytes, big-endian nibbles) plus escape triples for |v| >= 2048
// and a separate int32 warm-up slab — ~25% fewer wire bytes than int16
// over the host->device link, unpacked with vectorized shifts on device.
//
//   pack12  [B x stride*3/2] uint8   (warm-up region packed as zeros)
//   warm    [B x 32] int32           raw warm-up samples
//   esc_*   escape triples (row, pos, val) appended at *esc_count,
//           capacity esc_cap (returns -9 in *status when exceeded)
int flac_parse_group12(const uint8_t* buf, int64_t nbytes, int64_t* bit_pos,
                       int si_rate, int si_bps, int si_max_blocksize,
                       int channels, int max_frames, int64_t stride,
                       int check_crc16,
                       int32_t* data, int32_t* coeffs, int32_t* shift,
                       int32_t* order, int32_t* wasted, int32_t* assign,
                       int32_t* blocksize, int64_t* sample_number,
                       int* status,
                       uint8_t* pack12, int32_t* warm,
                       int32_t* esc_row, int32_t* esc_pos, int32_t* esc_val,
                       int32_t* esc_count, int esc_cap, int row0) {
    int n = flac_parse_group(buf, nbytes, bit_pos, si_rate, si_bps,
                             si_max_blocksize, channels, max_frames, stride,
                             check_crc16, data, coeffs, shift, order, wasted,
                             assign, blocksize, sample_number, status);
    int64_t rows = (int64_t)n * channels;
    int64_t cap_rows = (int64_t)max_frames * channels;
    int64_t pbytes = stride * 3 / 2;
    for (int64_t r = 0; r < rows; r++) {
        const int32_t* src = data + r * stride;
        uint8_t* dst = pack12 + r * pbytes;
        int o = order[r];
        for (int i = 0; i < 32; i++)
            warm[r * 32 + i] = i < o ? src[i] : 0;
        for (int64_t i = 0; i < stride; i += 2) {
            int32_t v0 = (i >= o) ? src[i] : 0;
            int32_t v1 = (i + 1 >= o && i + 1 < stride) ? src[i + 1] : 0;
            if (v0 < -2048 || v0 > 2047) {
                if (*esc_count >= esc_cap) { *status = -9; return n; }
                int j = (*esc_count)++;
                esc_row[j] = (int32_t)(row0 + r);
                esc_pos[j] = (int32_t)i;
                esc_val[j] = v0;
                v0 = 0;
            }
            if (v1 < -2048 || v1 > 2047) {
                if (*esc_count >= esc_cap) { *status = -9; return n; }
                int j = (*esc_count)++;
                esc_row[j] = (int32_t)(row0 + r);
                esc_pos[j] = (int32_t)(i + 1);
                esc_val[j] = v1;
                v1 = 0;
            }
            uint32_t u0 = (uint32_t)(v0 & 0xFFF);
            uint32_t u1 = (uint32_t)(v1 & 0xFFF);
            dst[i / 2 * 3] = (uint8_t)(u0 >> 4);
            dst[i / 2 * 3 + 1] = (uint8_t)(((u0 & 0xF) << 4) | (u1 >> 8));
            dst[i / 2 * 3 + 2] = (uint8_t)(u1 & 0xFF);
        }
    }
    memset(pack12 + rows * pbytes, 0,
           (size_t)((cap_rows - rows) * pbytes));
    memset(warm + rows * 32, 0, (size_t)((cap_rows - rows) * 32) * 4);
    return n;
}

// As flac_parse_group, but ships residuals as zigzag byte planes tuned for
// the compressing host->device link: a low-byte plane (B x stride, u8) that
// carries the noise-like residual low bits, and a packed high-nibble plane
// (B x stride/2, u8) that is mostly zero and collapses under the link's
// LZ-style compression.  zz = (v << 1) ^ (v >> 31); values with zz >= 4095
// (|v| > 2047) become escape triples (row, pos, val) and pack as zero.
// Warm-up samples live in `warm` (B x 32 int32) like flac_parse_group12.
int flac_parse_group_zz(const uint8_t* buf, int64_t nbytes, int64_t* bit_pos,
                        int si_rate, int si_bps, int si_max_blocksize,
                        int channels, int max_frames, int64_t stride,
                        int check_crc16,
                        int32_t* data, int32_t* coeffs, int32_t* shift,
                        int32_t* order, int32_t* wasted, int32_t* assign,
                        int32_t* blocksize, int64_t* sample_number,
                        int* status,
                        uint8_t* lo, uint8_t* hi, int32_t* warm,
                        int32_t* esc_row, int32_t* esc_pos, int32_t* esc_val,
                        int32_t* esc_count, int esc_cap, int64_t row0) {
    int n = flac_parse_group(buf, nbytes, bit_pos, si_rate, si_bps,
                             si_max_blocksize, channels, max_frames, stride,
                             check_crc16, data, coeffs, shift, order, wasted,
                             assign, blocksize, sample_number, status);
    int64_t rows = (int64_t)n * channels;
    int64_t cap_rows = (int64_t)max_frames * channels;
    int64_t hbytes = stride / 2;
    for (int64_t r = 0; r < rows; r++) {
        const int32_t* src = data + r * stride;
        uint8_t* lrow = lo + r * stride;
        uint8_t* hrow = hi + r * hbytes;
        int o = order[r];
        for (int i = 0; i < 32; i++)
            warm[r * 32 + i] = i < o ? src[i] : 0;
        for (int64_t i = 0; i < stride; i += 2) {
            uint32_t z0 = 0, z1 = 0;
            if (i >= o) {
                int32_t v = src[i];
                z0 = ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
                if (z0 >= 4095) {
                    if (*esc_count >= esc_cap) { *status = -9; return n; }
                    int j = (*esc_count)++;
                    esc_row[j] = (int32_t)(row0 + r);
                    esc_pos[j] = (int32_t)i;
                    esc_val[j] = v;
                    z0 = 0;
                }
            }
            if (i + 1 >= o && i + 1 < stride) {
                int32_t v = src[i + 1];
                z1 = ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
                if (z1 >= 4095) {
                    if (*esc_count >= esc_cap) { *status = -9; return n; }
                    int j = (*esc_count)++;
                    esc_row[j] = (int32_t)(row0 + r);
                    esc_pos[j] = (int32_t)(i + 1);
                    esc_val[j] = v;
                    z1 = 0;
                }
            }
            lrow[i] = (uint8_t)(z0 & 0xFF);
            if (i + 1 < stride) {
                lrow[i + 1] = (uint8_t)(z1 & 0xFF);
                hrow[i >> 1] = (uint8_t)(((z0 >> 8) & 0xF) |
                                         (((z1 >> 8) & 0xF) << 4));
            } else if ((i >> 1) < hbytes) {
                hrow[i >> 1] = (uint8_t)((z0 >> 8) & 0xF);
            }
        }
    }
    memset(lo + rows * stride, 0, (size_t)((cap_rows - rows) * stride));
    memset(hi + rows * hbytes, 0, (size_t)((cap_rows - rows) * hbytes));
    memset(warm + rows * 32, 0, (size_t)((cap_rows - rows) * 32) * 4);
    return n;
}

// Rice-wire variant: instead of expanding residuals into byte planes, the
// *entropy-coded stream bytes themselves* go to the device (the caller
// copies buf[(*bit_pos>>3) at entry : (*bit_pos>>3) at exit] into its
// transfer slab) and the device decodes the rice codes
// (codecs/flac/rice_jax.py).  This function emits the decode plan:
//
//   gcur/gk [cap_rows x stride/64]  bit cursor (relative to the entry
//           byte) + rice parameter per aligned full 64-sample unit;
//           gk = -1 marks an empty slot
//   o*      overflow units (cursor, k, mode 0=rice/1=verbatim, count,
//           global row, dst position) for partial/unaligned units
//   cf*     constant-subframe fills (global row, value, blocksize)
//   esc_*   escape triples for codewords the 32-bit device window cannot
//           hold (quotient > 15 or quotient+1+k > 32), as in the plane
//           variants
//   warm    [cap_rows x 32] int32 warm-up samples
//
// `data` stays fully decoded (host fallback/oracle); it is NOT shipped.
// status: -9/-10/-11 = esc/unit/cfill capacity exceeded.
int flac_parse_group_rice(const uint8_t* buf, int64_t nbytes,
                          int64_t* bit_pos,
                          int si_rate, int si_bps, int si_max_blocksize,
                          int channels, int max_frames, int64_t stride,
                          int check_crc16,
                          int32_t* data, int32_t* coeffs, int32_t* shift,
                          int32_t* order, int32_t* wasted, int32_t* assign,
                          int32_t* blocksize, int64_t* sample_number,
                          int* status,
                          int32_t* warm,
                          int32_t* gcur, int8_t* gk,
                          int32_t* ocur, int8_t* okk, int8_t* omode,
                          int8_t* ocnt, int32_t* orow, int32_t* opos,
                          int32_t* ocount, int ocap,
                          int32_t* cfrow, int32_t* cfval, int32_t* cfn,
                          int32_t* cfcount, int cfcap,
                          int32_t* esc_row, int32_t* esc_pos,
                          int32_t* esc_val,
                          int32_t* esc_count, int esc_cap, int64_t row0) {
    if (stride % 64) { *status = -12; return 0; }
    int slots = (int)(stride / 64);
    int64_t cap_rows = (int64_t)max_frames * channels;
    memset(gk, 0xFF, (size_t)(cap_rows * slots));
    memset(gcur, 0, (size_t)(cap_rows * slots) * 4);
    UnitSink sink;
    sink.base_bit = (*bit_pos >> 3) << 3;   // entry byte, bit units
    sink.slots = slots;
    sink.gcur = gcur;
    sink.gk = gk;
    sink.ocur = ocur;
    sink.okk = okk;
    sink.omode = omode;
    sink.ocnt = ocnt;
    sink.orow = orow;
    sink.opos = opos;
    sink.ocount = ocount;
    sink.ocap = ocap;
    sink.cfrow = cfrow;
    sink.cfval = cfval;
    sink.cfn = cfn;
    sink.cfcount = cfcount;
    sink.cfcap = cfcap;
    sink.esc_row = esc_row;
    sink.esc_pos = esc_pos;
    sink.esc_val = esc_val;
    sink.esc_count = esc_count;
    sink.esc_cap = esc_cap;
    sink.row0 = row0;
    int n = parse_group_core(buf, nbytes, bit_pos, si_rate, si_bps,
                             si_max_blocksize, channels, max_frames, stride,
                             check_crc16, data, coeffs, shift, order, wasted,
                             assign, blocksize, sample_number, status,
                             &sink);
    int64_t rows = (int64_t)n * channels;
    for (int64_t r = 0; r < rows; r++) {
        const int32_t* src = data + r * stride;
        int o = order[r];
        for (int i = 0; i < 32; i++)
            warm[r * 32 + i] = i < o ? src[i] : 0;
    }
    memset(warm + rows * 32, 0, (size_t)((cap_rows - rows) * 32) * 4);
    return n;
}

}  // extern "C"
