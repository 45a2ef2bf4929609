// SBR payload parser: the bit-serial LP-layer of HE-AAC's SBR
// extension (grids, delta-coded envelopes/noise via Huffman trees,
// inverse-filtering modes, sinusoidal flags) decoded in one native
// call per frame.  Mirrors ohpipeline_jax/codecs/aac/sbr.py
// parse_sbr_data / parse_grid bit-for-bit (that Python implementation
// stays the oracle and the fallback; tests/test_sbr_native_parse.py
// asserts field-exact agreement incl. cross-frame delta state).
//
// Reference stance: ISO 14496-3 4.6.18.3 sbr_data(); behavioural
// parity target thirdparty/fdk-aac/libSBRdec/src/env_extr.cpp.
// Huffman trees are injected from the Python side (sbr tables npz) —
// no tables are transcribed here.
//
// Parametric stereo (ps_data) is NOT parsed here: on the first
// EXTENSION_ID_PS the parser records the bit range and stops, and the
// Python PsData parser consumes exactly that range (PS state lives on
// the Python side).

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Bits {
    const uint8_t* data;
    int64_t pos;
    int64_t limit;
    bool ok = true;

    inline int read(int n) {
        int v = 0;
        for (int i = 0; i < n; i++) {
            if (pos >= limit) { ok = false; return 0; }
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1);
            pos++;
        }
        return v;
    }
};

// Injected (n, 2) Huffman trees: negative entry = leaf (value+64).
// ids: 0 EnvLevel10T 1 EnvLevel10F 2 EnvLevel11T 3 EnvLevel11F
//      4 EnvBalance10T 5 EnvBalance10F 6 EnvBalance11T 7 EnvBalance11F
//      8 NoiseLevel11T 9 NoiseBalance11T
struct Book { const int32_t* tree = nullptr; int n = 0; };
Book g_books[10];

inline int huff(Bits& b, const Book& bk) {
    int node = 0;
    while (b.ok) {
        if (node < 0 || node >= bk.n) { b.ok = false; return 0; }
        node = bk.tree[node * 2 + b.read(1)];
        if (node < 0) return node + 64;
    }
    return 0;
}

inline int ceil_log2(int x) {
    if (x <= 1) return 0;
    int n = 0;
    while ((1 << n) < x) n++;
    return n;
}

constexpr int MAXENV = 5;
constexpr int MAXB = 64;     // band rows (n_high <= 49)
constexpr int MAXQ = 8;
constexpr int MAXT = 16;     // t_env entries (VARVAR sorted-set union)

struct Grid {
    int frame_class = 0, n_env = 1, pointer = 0, tran_env = -1;
    int n_noise = 1, nt = 2;
    int t_env[MAXT] = {0, 16};
    int t_noise[3] = {0, 16, 0};
    int freq_res[MAXENV] = {1};
};

// mirrors sbr.py parse_grid exactly (incl. the FIXFIX/FIXVAR/VARFIX/
// VARVAR border arithmetic and the noise-grid middle selection)
bool parse_grid(Bits& b, Grid& g) {
    const int nts = 16;
    g.frame_class = b.read(2);
    if (g.frame_class == 0) {                     // FIXFIX
        int tmp = b.read(2);
        g.n_env = std::min(4, 1 << tmp);
        int fr = b.read(1);
        for (int e = 0; e < g.n_env; e++) g.freq_res[e] = fr;
        g.nt = g.n_env + 1;
        for (int i = 0; i <= g.n_env; i++) {
            // round-half-even like Python round()
            double v = (double)i * nts / g.n_env;
            double fl = (double)(int64_t)v;
            double fr2 = v - fl;
            int64_t r;
            if (fr2 > 0.5) r = (int64_t)fl + 1;
            else if (fr2 < 0.5) r = (int64_t)fl;
            else r = ((int64_t)fl % 2 == 0) ? (int64_t)fl
                                            : (int64_t)fl + 1;
            g.t_env[i] = (int)r;
        }
        g.pointer = 0;
        g.tran_env = -1;
    } else if (g.frame_class == 1) {              // FIXVAR
        int var_bord = b.read(2);
        int n_rel = b.read(2);
        g.n_env = n_rel + 1;
        int rel[4];
        for (int i = 0; i < n_rel; i++) rel[i] = 2 * b.read(2) + 2;
        g.pointer = b.read(ceil_log2(g.n_env + 1));
        int fr[MAXENV];
        for (int e = 0; e < g.n_env; e++) fr[e] = b.read(1);
        for (int e = 0; e < g.n_env; e++)
            g.freq_res[e] = fr[g.n_env - 1 - e];
        int borders[8];
        borders[0] = nts + var_bord;
        for (int i = 0; i < n_rel; i++)
            borders[i + 1] = borders[i] - rel[i];
        g.nt = n_rel + 2;
        g.t_env[0] = 0;
        for (int i = 0; i <= n_rel; i++)
            g.t_env[1 + i] = borders[n_rel - i];
        g.tran_env = g.pointer ? (n_rel + 2 - g.pointer) : -1;
    } else if (g.frame_class == 2) {              // VARFIX
        int var_bord = b.read(2);
        int n_rel = b.read(2);
        g.n_env = n_rel + 1;
        int rel[4];
        for (int i = 0; i < n_rel; i++) rel[i] = 2 * b.read(2) + 2;
        g.pointer = b.read(ceil_log2(g.n_env + 1));
        for (int e = 0; e < g.n_env; e++) g.freq_res[e] = b.read(1);
        g.nt = n_rel + 2;
        g.t_env[0] = var_bord;
        for (int i = 0; i < n_rel; i++)
            g.t_env[i + 1] = g.t_env[i] + rel[i];
        g.t_env[n_rel + 1] = nts;
        g.tran_env = (g.pointer < 2) ? -1 : g.pointer - 1;
    } else {                                      // VARVAR
        int bord0 = b.read(2);
        int bord1 = b.read(2);
        int nrel0 = b.read(2);
        int nrel1 = b.read(2);
        g.n_env = std::min(5, nrel0 + nrel1 + 1);
        int rel0[4], rel1[4];
        for (int i = 0; i < nrel0; i++) rel0[i] = 2 * b.read(2) + 2;
        for (int i = 0; i < nrel1; i++) rel1[i] = 2 * b.read(2) + 2;
        g.pointer = b.read(ceil_log2(g.n_env + 1));
        for (int e = 0; e < g.n_env; e++) g.freq_res[e] = b.read(1);
        int all[12];
        int n_all = 0;
        int v = bord0;
        all[n_all++] = v;
        for (int i = 0; i < nrel0; i++) { v += rel0[i]; all[n_all++] = v; }
        v = nts + bord1;
        all[n_all++] = v;
        for (int i = 0; i < nrel1; i++) { v -= rel1[i]; all[n_all++] = v; }
        std::sort(all, all + n_all);
        g.nt = 0;
        for (int i = 0; i < n_all; i++)
            if (g.nt == 0 || all[i] != g.t_env[g.nt - 1])
                g.t_env[g.nt++] = all[i];
        // tranEnv = #borders - pointer = nEnv + 1 - p (env_extr.cpp:1256)
        g.tran_env = g.pointer ? ((nrel0 + nrel1 + 2) - g.pointer) : -1;
    }
    if (!b.ok || g.n_env < 1 || g.n_env > MAXENV || g.nt < 2
        || g.nt > MAXT)
        return false;
    // out-of-spec pointer: reject like fdk's extractFrameInfo
    // (bs_pointer > bs_num_env + 1) — mirrors the Python SbrError
    if (g.pointer > g.n_env + 1) return false;
    // noise grid
    if (g.n_env == 1) {
        g.n_noise = 1;
        g.t_noise[0] = g.t_env[0];
        g.t_noise[1] = g.t_env[g.nt - 1];
    } else {
        g.n_noise = 2;
        int mi;
        if (g.frame_class == 0) {
            mi = g.n_env / 2;
        } else if (g.frame_class == 2) {
            if (g.pointer == 0) mi = 1;
            else if (g.pointer == 1) mi = g.n_env - 1;
            else mi = g.pointer - 1;
        } else {
            if (g.pointer > 1) mi = g.n_env + 1 - g.pointer;
            else mi = g.n_env - 1;
        }
        // VARVAR border-set dedup can shrink t_env below n_env+1
        if (mi < 0 || mi >= g.nt) return false;
        g.t_noise[0] = g.t_env[0];
        g.t_noise[1] = g.t_env[mi];
        g.t_noise[2] = g.t_env[g.nt - 1];
    }
    return true;
}

struct PrevState {
    const int32_t* env;    // prev env row or nullptr
    int env_len;
    int res;
    const int32_t* noise;  // prev noise row or nullptr
};

// sbr.py _map_prev: map band k of resolution `res` onto the previous
// row at resolution prev_res (cross-resolution via injected index maps)
inline int map_prev(const int32_t* prev, int prev_len, int prev_res,
                    int k, int res,
                    const int32_t* idx_h2l, const int32_t* idx_l2h) {
    if (prev == nullptr || prev_len <= 0) return 0;
    int i;
    if (prev_res == res) i = k;
    else if (res == 1 && prev_res == 0) i = idx_h2l[k];
    else i = idx_l2h[k];
    if (i < 0) i = 0;
    if (i >= prev_len) i = prev_len - 1;
    return prev[i];
}

}  // namespace

extern "C" {

void sbr_set_book(int id, const int32_t* tree, int n) {
    if (id >= 0 && id < 10) { g_books[id].tree = tree; g_books[id].n = n; }
}

// Returns 1 on success, 0 on parse error/overrun (caller falls back to
// the Python parser without having touched any state).
//
// grid_out per channel (int32[32]):
//   [0] frame_class [1] n_env [2] pointer [3] tran_env [4] n_noise
//   [5] nt  [6..6+nt) t_env  [22..25) t_noise  [25..30) freq_res
// env_rows  int32[2][MAXENV][MAXB], noise_rows int32[2][2][MAXQ],
// df_env int32[2][MAXENV], df_noise int32[2][2], invf int32[2][MAXQ],
// add_harm int32[2][MAXB], ps_bits int64[2] = {start,end} or {-1,-1}.
int sbr_parse_payload(
    const uint8_t* buf, int64_t nbits, int64_t start_bit,
    int stereo, int amp_res,
    int n_q, int n_low, int n_high,
    const int32_t* idx_h2l, const int32_t* idx_l2h,
    const int32_t* prev_env, const int32_t* prev_env_len,
    const int32_t* prev_res, const int32_t* prev_noise,
    const int32_t* prev_noise_have,
    int32_t* grid_out, int32_t* df_env, int32_t* df_noise,
    int32_t* invf, int32_t* env_rows, int32_t* noise_rows,
    int32_t* add_harm, int64_t* ps_bits, int32_t* coupling_out) {
    if (n_q > MAXQ || n_high > MAXB || n_low > MAXB) return 0;
    Bits b{buf, start_bit, nbits};
    const int nch = stereo ? 2 : 1;
    int coupling = 0;
    if (stereo) {
        if (b.read(1)) { b.read(4); b.read(4); }   // bs_data_extra
        coupling = b.read(1);
    } else {
        if (b.read(1)) b.read(4);
    }
    Grid grids[2];
    if (stereo && coupling) {
        if (!parse_grid(b, grids[0])) return 0;
        grids[1] = grids[0];
    } else {
        if (!parse_grid(b, grids[0])) return 0;
        if (stereo && !parse_grid(b, grids[1])) return 0;
    }
    for (int c = 0; c < nch; c++) {
        Grid& g = grids[c];
        for (int e = 0; e < g.n_env; e++)
            df_env[c * MAXENV + e] = b.read(1);
        for (int e = 0; e < g.n_noise; e++)
            df_noise[c * 2 + e] = b.read(1);
    }
    if (stereo && coupling) {
        for (int q = 0; q < n_q; q++) invf[q] = b.read(2);
        for (int q = 0; q < n_q; q++) invf[MAXQ + q] = invf[q];
    } else {
        for (int q = 0; q < n_q; q++) invf[q] = b.read(2);
        if (stereo)
            for (int q = 0; q < n_q; q++) invf[MAXQ + q] = b.read(2);
    }
    if (!b.ok) return 0;

    // env/noise readers (mirror read_env/read_noise incl. balance
    // doubling and cross-frame/cross-envelope delta references)
    auto read_env = [&](int c, bool second) -> bool {
        Grid& g = grids[c];
        int amp = amp_res;
        if (g.frame_class == 0 && g.n_env == 1) amp = 0;
        bool bal = stereo && coupling && second;
        const Book& t_book = g_books[amp ? (bal ? 6 : 2) : (bal ? 4 : 0)];
        const Book& f_book = g_books[amp ? (bal ? 7 : 3) : (bal ? 5 : 1)];
        int start_bits = amp ? (bal ? 5 : 6) : (bal ? 6 : 7);
        const int32_t* pv = prev_env_len[c] > 0
            ? prev_env + c * MAXB : nullptr;
        int pv_len = prev_env_len[c];
        int pv_res = prev_res[c];
        for (int e = 0; e < g.n_env; e++) {
            int nb = g.freq_res[e] ? n_high : n_low;
            int32_t* row = env_rows + (c * MAXENV + e) * MAXB;
            if (df_env[c * MAXENV + e] == 0) {
                int v0 = b.read(start_bits);
                if (bal) v0 *= 2;
                row[0] = v0;
                for (int k = 1; k < nb; k++) {
                    int d = huff(b, f_book);
                    row[k] = row[k - 1] + (bal ? d * 2 : d);
                }
            } else {
                const int32_t* prow;
                int plen, pres;
                if (e > 0) {
                    prow = env_rows + (c * MAXENV + e - 1) * MAXB;
                    plen = g.freq_res[e - 1] ? n_high : n_low;
                    pres = g.freq_res[e - 1];
                } else {
                    prow = pv; plen = pv_len; pres = pv_res;
                }
                for (int k = 0; k < nb; k++) {
                    int d = huff(b, t_book) * (bal ? 2 : 1);
                    row[k] = map_prev(prow, plen, pres, k, g.freq_res[e],
                                      idx_h2l, idx_l2h) + d;
                }
            }
            if (!b.ok) return false;
        }
        return true;
    };
    auto read_noise = [&](int c, bool second) -> bool {
        Grid& g = grids[c];
        bool bal = stereo && coupling && second;
        const Book& t_book = g_books[bal ? 9 : 8];
        const Book& f_book = g_books[bal ? 7 : 3];
        const int32_t* pv = prev_noise_have[c]
            ? prev_noise + c * MAXQ : nullptr;
        for (int e = 0; e < g.n_noise; e++) {
            int32_t* row = noise_rows + (c * 2 + e) * MAXQ;
            if (df_noise[c * 2 + e] == 0) {
                int v0 = b.read(5);
                if (bal) v0 *= 2;
                row[0] = v0;
                for (int k = 1; k < n_q; k++) {
                    int d = huff(b, f_book);
                    row[k] = row[k - 1] + (bal ? d * 2 : d);
                }
            } else {
                const int32_t* prow = (e > 0)
                    ? noise_rows + (c * 2 + e - 1) * MAXQ : pv;
                for (int k = 0; k < n_q; k++) {
                    int d = huff(b, t_book) * (bal ? 2 : 1);
                    row[k] = (prow ? prow[k] : 0) + d;
                }
            }
            if (!b.ok) return false;
        }
        return true;
    };

    if (stereo && !coupling) {
        if (!read_env(0, false) || !read_env(1, false)) return 0;
        if (!read_noise(0, false) || !read_noise(1, false)) return 0;
    } else {
        if (!read_env(0, false) || !read_noise(0, false)) return 0;
        if (stereo) {
            if (!read_env(1, true) || !read_noise(1, true)) return 0;
        }
    }

    for (int c = 0; c < nch; c++) {
        memset(add_harm + c * MAXB, 0, sizeof(int32_t) * MAXB);
        if (b.read(1))
            for (int k = 0; k < n_high; k++)
                add_harm[c * MAXB + k] = b.read(1);
    }
    if (!b.ok) return 0;

    // bs_extended_data: skip non-PS sub-extensions; on PS record the
    // bit range for the Python PsData parser and stop
    ps_bits[0] = ps_bits[1] = -1;
    if (b.read(1)) {
        int cnt = b.read(4);
        if (cnt == 15) cnt += b.read(8);
        int64_t end = b.pos + 8 * (int64_t)cnt;
        if (end > nbits) end = nbits;
        while (end - b.pos > 7) {
            int ext_id = b.read(2);
            if (ext_id == 2) {
                ps_bits[0] = b.pos;
                ps_bits[1] = end;
                break;
            }
            while (end - b.pos >= 8) b.read(8);
        }
    }
    if (!b.ok) return 0;

    for (int c = 0; c < nch; c++) {
        Grid& g = grids[c];
        int32_t* go = grid_out + c * 32;
        go[0] = g.frame_class; go[1] = g.n_env; go[2] = g.pointer;
        go[3] = g.tran_env; go[4] = g.n_noise; go[5] = g.nt;
        for (int i = 0; i < g.nt; i++) go[6 + i] = g.t_env[i];
        for (int i = 0; i < g.n_noise + 1; i++) go[22 + i] = g.t_noise[i];
        for (int e = 0; e < g.n_env; e++) go[25 + e] = g.freq_res[e];
    }
    *coupling_out = coupling;
    return 1;
}

}  // extern "C"
