"""AAC-LC synthesis: host spectral prep (dequant, M/S, intensity, PNS,
TNS — cheap vectorized numpy) + the FLOP-heavy filterbank (IMDCT matmuls,
windowing, overlap-add) as one batched jitted device program.

Filterbank math from ISO/IEC 14496-3 4.6.11: N=2048 IMDCT for long
windows, 8 x N=256 for short, sine and KBD window shapes, 50% overlap-add.
The IMDCT is expressed as a (1024->2048) matmul so frames batch into one
matrix product; frames advance under lax.scan carrying the overlap buffer.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import tables as T
from .bitstream import (EIGHT_SHORT, LONG_START, LONG_STOP, ONLY_LONG,
                        ChannelData, FrameData, IcsInfo)

# ---------------------------------------------------------------------------
# windows & IMDCT operators (host-precomputed constants)
# ---------------------------------------------------------------------------


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    # Kaiser-Bessel derived (ISO 14496-3 4.6.11.3.2)
    half = n // 2
    t = np.arange(half + 1)
    kaiser = np.i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t / half - 1.0) ** 2))
    cum = np.cumsum(kaiser)
    w = np.sqrt(cum[:half] / cum[half])
    return np.concatenate([w, w[::-1]])


@functools.lru_cache(maxsize=None)
def _windows():
    return dict(
        long_sine=_sine_window(2048), long_kbd=_kbd_window(2048, 4.0),
        short_sine=_sine_window(256), short_kbd=_kbd_window(256, 6.0))


@functools.lru_cache(maxsize=None)
def _imdct_matrix(n_out: int) -> np.ndarray:
    """(n_out/2, n_out) operator: x = M.T @ X."""
    N = n_out
    k = np.arange(N // 2)
    n = np.arange(N)
    M = (2.0 / N) * np.cos(2.0 * np.pi / N * (n[None, :] + 0.5 + N / 4)
                           * (k[:, None] + 0.5))
    return M.astype(np.float32)       # (N/2, N)


def _long_halves(shape: int) -> tuple[np.ndarray, np.ndarray]:
    w = _windows()["long_kbd" if shape else "long_sine"]
    return w[:1024], w[1024:]


def _short_halves(shape: int) -> tuple[np.ndarray, np.ndarray]:
    w = _windows()["short_kbd" if shape else "short_sine"]
    return w[:128], w[128:]


@functools.lru_cache(maxsize=None)
def _frame_operators():
    """Per (window_mode, left_shape, right_shape): two (1024, 1024) f32
    linear operators A, Bop with

        time_first_half  = A    @ spec    (added to carried overlap)
        next_overlap     = Bop  @ spec

    This folds IMDCT + windowing + short-window internal overlap into two
    dense matmuls, uniform across all window sequences.
    """
    M_long = _imdct_matrix(2048)      # (1024, 2048)
    M_short = _imdct_matrix(256)      # (128, 256)
    ops = {}
    for mode in (ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP):
        for ls in (0, 1):
            for rs in (0, 1):
                full = np.zeros((1024, 2048), np.float32)
                if mode == EIGHT_SHORT:
                    wl, wr = _short_halves(rs)
                    wl_first, _ = _short_halves(ls)
                    for w in range(8):
                        off = 448 + w * 128
                        win = np.concatenate(
                            [wl_first if w == 0 else wl, wr])
                        contrib = (M_short * win[None, :]).astype(np.float32)
                        full[w * 128:(w + 1) * 128, off:off + 256] += contrib
                else:
                    wl_l, wl_r = _long_halves(ls)
                    if mode == ONLY_LONG:
                        win = np.concatenate([wl_l, _long_halves(rs)[1]])
                    elif mode == LONG_START:
                        swl, swr = _short_halves(rs)
                        right = np.concatenate(
                            [np.ones(448), swr, np.zeros(448)])
                        win = np.concatenate([wl_l, right])
                    else:  # LONG_STOP
                        swl, _ = _short_halves(ls)
                        left = np.concatenate(
                            [np.zeros(448), swl, np.ones(448)])
                        win = np.concatenate([left, _long_halves(rs)[1]])
                    full = (M_long * win[None, :]).astype(np.float32)
                ops[(mode, ls, rs)] = (
                    np.ascontiguousarray(full[:, :1024]),   # (k, n) 1024^2
                    np.ascontiguousarray(full[:, 1024:]))
    return ops


def operator_bank() -> tuple[np.ndarray, np.ndarray]:
    """Stacked (16, 1024, 1024) A and B operator banks indexed by
    mode*4 + left_shape*2 + right_shape."""
    ops = _frame_operators()
    A = np.stack([ops[(m, l, r)][0] for m in range(4) for l in (0, 1)
                  for r in (0, 1)])
    B = np.stack([ops[(m, l, r)][1] for m in range(4) for l in (0, 1)
                  for r in (0, 1)])
    return A, B


# ---------------------------------------------------------------------------
# device filterbank
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def window_bank():
    """(16, 2048) full-frame windows per opidx (mode*4 + ls*2 + rs) for the
    non-short modes, plus (4, 8, 256) per-window short windows per (ls, rs)
    keyed by opidx & 3."""
    W = np.zeros((16, 2048), np.float32)
    SW = np.zeros((4, 8, 256), np.float32)
    for mode in (ONLY_LONG, LONG_START, LONG_STOP):
        for ls in (0, 1):
            for rs in (0, 1):
                wl_l, _ = _long_halves(ls)
                if mode == ONLY_LONG:
                    win = np.concatenate([wl_l, _long_halves(rs)[1]])
                elif mode == LONG_START:
                    _, swr = _short_halves(rs)
                    win = np.concatenate([wl_l, np.ones(448), swr,
                                          np.zeros(448)])
                else:
                    swl, _ = _short_halves(ls)
                    win = np.concatenate([np.zeros(448), swl, np.ones(448),
                                          _long_halves(rs)[1]])
                W[mode * 4 + ls * 2 + rs] = win
    for ls in (0, 1):
        for rs in (0, 1):
            wl, wr = _short_halves(rs)
            wl_first, _ = _short_halves(ls)
            for w in range(8):
                SW[ls * 2 + rs, w] = np.concatenate(
                    [wl_first if w == 0 else wl, wr])
    return W, SW


@jax.jit
def dequant_filterbank(quant, sf, coded, cfg_idx, perm_tab, band_tab,
                       ms_flag, side_spec, side_row, opidx_t, overlap,
                       M_long, M_short, W, SW):
    """Fully device-side AAC decode for the common case: dequantization,
    scalefactor gains, M/S, and the filterbank in one jit — the host ships
    only int16 quantized coefficients plus small metadata.

    quant (T, B, 1024) int16/int32 transmission-order coefficients
    sf    (T, B, 128) int16 scalefactors per band slot
    coded (T, B, 128) uint8  1 where the slot carries spectral data
    cfg_idx (T, B) int32     row -> layout config (index into tables)
    perm_tab (NCFG, 1024) int32  dst -> src transmission position
    band_tab (NCFG, 1024) int32  dst -> band slot (127 = silent)
    ms_flag (T, B//2, 128) uint8 M/S per band for each channel pair
    side_spec (S, 1024) f32  host-prepared rows (TNS/intensity/PNS)
    side_row (S,) int32      flat row index each side row replaces (-1 pad)
    """
    Tn, B, _ = quant.shape
    q = quant.astype(jnp.float32).reshape(Tn * B, 1024)
    mag = jnp.abs(q) ** (4.0 / 3.0)
    dq = jnp.sign(q) * mag
    perm = perm_tab[cfg_idx.reshape(-1)]              # (TB, 1024)
    band = band_tab[cfg_idx.reshape(-1)]
    spec_tx = jnp.take_along_axis(dq, perm, axis=1)
    sf_f = sf.reshape(Tn * B, 128)
    gains = jnp.exp2(0.25 * (sf_f.astype(jnp.float32) - 100.0))
    gains = gains * coded.reshape(Tn * B, 128).astype(jnp.float32)
    # slot 127 backs band_tab's "silent" marker for unused dst positions;
    # it must stay 0 even when `coded` is implicit (sparse wire path)
    gains = gains.at[:, 127].set(0.0)
    g = jnp.take_along_axis(gains, band, axis=1)
    spec = spec_tx * g                                 # (TB, 1024)
    # M/S per pair: mid/side -> left/right
    spec_p = spec.reshape(Tn, B // 2, 2, 1024)
    band_l = band.reshape(Tn, B // 2, 2, 1024)[:, :, 0]
    ms = jnp.take_along_axis(ms_flag.astype(jnp.float32), band_l, axis=2)
    mid = spec_p[:, :, 0]
    side = spec_p[:, :, 1]
    left = jnp.where(ms > 0, mid + side, mid)
    right = jnp.where(ms > 0, mid - side, side)
    spec = jnp.stack([left, right], axis=2).reshape(Tn * B, 1024)
    # overwrite exception rows with host-prepared spectra: one scatter,
    # padding rows routed to a dummy row beyond the real range
    dummy = Tn * B
    idx = jnp.where(side_row >= 0, side_row, dummy)
    spec_ext = jnp.concatenate(
        [spec, jnp.zeros((1, 1024), spec.dtype)], axis=0)
    spec_ext = spec_ext.at[idx].set(side_spec)
    spec = spec_ext[:dummy]
    return filterbank_fast(spec.reshape(Tn, B, 1024), opidx_t, overlap,
                           M_long, M_short, W, SW)


def dequant_filterbank_sparse(mask, vals, esc_row, esc_pos, esc_val, sf_u8,
                              cfg_idx, perm_tab, band_tab, ms_flag,
                              side_spec, side_row, opidx_t, overlap,
                              M_long, M_short, W, SW):
    """dequant_filterbank fed by the sparse wire format
    (native.aac_prepare_rows_sparse): quantized coefficients arrive as a
    position bitmask (T, B, 128) uint8 + rank-ordered int8 values
    (T, B, vcap) + escape triples for |q| >= 128; sf is uint8 on coded
    slots only (uncoded slots are 0, so coded gating is implicit in the
    reconstructed zeros).  ~4x fewer host->device bytes at 128 kbps."""
    Tn, B, _ = mask.shape
    bits = ((mask.reshape(Tn * B, 128, 1).astype(jnp.int32)
             >> jnp.arange(7, -1, -1, dtype=jnp.int32)) & 1)
    bits = bits.reshape(Tn * B, 1024)
    ranks = jnp.cumsum(bits, axis=1) - 1
    vcap = vals.shape[-1]
    v = jnp.take_along_axis(vals.reshape(Tn * B, vcap).astype(jnp.int32),
                            jnp.clip(ranks, 0, vcap - 1), axis=1) * bits
    flat = v.reshape(-1)
    dummy = Tn * B * 1024
    eidx = jnp.where(esc_row >= 0, esc_row * 1024 + esc_pos, dummy)
    flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
    flat = flat.at[eidx].set(esc_val)
    q = flat[:dummy].reshape(Tn, B, 1024)
    coded = jnp.ones((Tn, B, 128), jnp.uint8)
    return dequant_filterbank(q, sf_u8.astype(jnp.int16), coded, cfg_idx,
                              perm_tab, band_tab, ms_flag, side_spec,
                              side_row, opidx_t, overlap,
                              M_long, M_short, W, SW)


def _fast_cbrt(x):
    """Elementwise cube root for non-negative f32 via exponent bit-trick
    seed + 3 Newton steps — avoids XLA's transcendental pow lowering
    with plain multiplies and adds.  Exact to ~1e-7 relative over
    the AAC quantizer range [1, 8191]; x == 0 yields a finite garbage
    value that callers must mask (q * cbrt(|q|) handles it for free)."""
    i = jax.lax.bitcast_convert_type(jnp.maximum(x, 1e-30), jnp.int32)
    y = jax.lax.bitcast_convert_type(i // 3 + 0x2A514067, jnp.float32)
    for _ in range(3):
        y = (2.0 * y + x / (y * y)) * (1.0 / 3.0)
    return y


def _exp2_quarter(k):
    """Elementwise 2**(k/4) for int32 k in [-126*4, 127*4): exponent-field
    construction for the integer part, a 4-way select for the fraction."""
    e = k >> 2
    r = k & 3
    base = jax.lax.bitcast_convert_type((e + 127) << 23, jnp.float32)
    frac = jnp.where(r == 0, 1.0,
                     jnp.where(r == 1, 1.189207115002721,
                               jnp.where(r == 2, 1.4142135623730951,
                                         1.681792830507429)))
    return base * frac.astype(jnp.float32)


def sf_expand_matrix(rate_index: int) -> np.ndarray:
    """(64, 1024) one-hot expansion: long-window band k -> its coefficient
    span (per the rate's long sfb offsets).  Coefficients beyond the last
    band map to no row (expanded byte 0)."""
    offsets = T.sfb_offsets(rate_index, False)
    E = np.zeros((64, 1024), np.float32)
    for k in range(min(64, len(offsets) - 1)):
        E[k, int(offsets[k]):int(offsets[k + 1])] = 1.0
    return E


def _tns_scan_device(x, fid, dirs, coefs, direction):
    """One masked all-pole scan along frequency over gathered TNS rows.
    x (P, 1024) f32; fid (P, 1024) i32 filter slot+1 (0 = none); dirs
    (P, 1024) i32 per-bin filter direction; coefs (P, 1024, 12) f32
    per-bin direct-form coefficients; applies only bins whose filter
    runs in `direction`.  History resets at each region start (fdk
    CTns_Apply zero filter state per filter)."""
    active = (fid > 0) & (dirs == direction)
    prev_fid = jnp.concatenate(
        [jnp.full_like(fid[:, :1], -1), fid[:, :-1]], axis=1)
    reset = active & (fid != prev_fid)

    def step(hist, inp):
        xi, ai, ci, ri = inp
        hist = jnp.where(ri[:, None], 0.0, hist)
        y = xi - jnp.where(ai, jnp.sum(ci * hist, axis=1), 0.0)
        hist = jnp.concatenate([y[:, None], hist[:, :-1]], axis=1)
        return hist, y

    P = x.shape[0]
    init = jnp.zeros((P, 12), x.dtype)
    _, ys = jax.lax.scan(
        step, init,
        (x.T, active.T, jnp.swapaxes(coefs, 0, 1), reset.T))
    return ys.T


def apply_tns_zz(spec, tfi, tco, tdir, trow):
    """Device-side TNS synthesis filtering for the zigzag wire
    (planes from native.aac_prepare_rows_zz's TnsPool): gathers the
    pooled rows out of spec (TB, 1024), runs an upward scan then a
    downward scan on the flipped axis (all-pole lattice filters per
    fdk aacdec_tns.cpp / native aac_unpack.cc:aac_tns_group; regions
    are disjoint so the two passes commute), scatters the rows back."""
    TB = spec.shape[0]
    P = tfi.shape[0]
    rows = jnp.where(trow >= 0, trow, 0)
    x = spec[rows]
    fid = tfi.astype(jnp.int32)
    dir_ext = jnp.concatenate(
        [jnp.zeros((P, 1), jnp.int32), tdir.astype(jnp.int32)], axis=1)
    dirs = jnp.take_along_axis(dir_ext, fid, axis=1)
    coef_ext = jnp.concatenate(
        [jnp.zeros((P, 1, 12), tco.dtype), tco], axis=1)
    coefs = jnp.take_along_axis(coef_ext, fid[:, :, None], axis=1)
    x = _tns_scan_device(x, fid, dirs, coefs, 0)
    x = jnp.flip(
        _tns_scan_device(jnp.flip(x, 1), jnp.flip(fid, 1),
                         jnp.flip(dirs, 1), jnp.flip(coefs, 1), 1), 1)
    sidx = jnp.where(trow >= 0, trow, TB)
    spec_ext = jnp.concatenate([spec, jnp.zeros((1, 1024), spec.dtype)])
    return spec_ext.at[sidx].set(x)[:TB]


def decode_chunk_zz(q4, sfb, ssf, ssr, msb, opx, esc_row, esc_pos, esc_val,
                    side_q, side_row, overlap,
                    M_long, M_short, W, SW, E_sf,
                    tfi=None, tco=None, tdir=None, trow=None):
    """Scan-free whole-chunk AAC-LC decode for the zigzag-nibble wire
    (native.aac_prepare_rows_zz).  Everything the per-step path did with
    per-element gathers (config tables, permutations, rank reconstruction)
    is gone: the host lays values out at spectral positions and expands
    scalefactors per coefficient, so the device program is elementwise ops
    plus three matmuls (window one-hots + IMDCT) and an overlap-add
    expressed as a shifted slice instead of a lax.scan.

    q4 (T, B, 512) u8 zigzag nibbles; sfb (T, B, 64) u8 per-band
    scalefactor bytes for long rows, expanded per coefficient with the
    one-hot E_sf (64, 1024) matmul; ssf (S2, 1024) u8 + ssr (S2,) pooled
    per-coefficient bytes for short-window rows (scattered over the
    expansion); msb (T, B//2, 128) u8 M/S bitmask (LSB-first); opx (T, B)
    window-operator index; escapes flat over T*B rows (|q| > 7, raw
    values); side_q (S, 1024) i16 + side_scale (S,) f32 host-prepared
    exception spectra (TNS/PNS/intensity/short-special), side_row (S,)
    flat row each replaces (-1 pad); overlap (B, 1024) f32 carried across
    chunks.  Returns (pcm (T, B, 1024) f32, new_overlap)."""
    Tn, B, _ = sfb.shape
    TB = Tn * B
    b = q4.reshape(TB, 512).astype(jnp.int32)
    zz = jnp.stack([b & 15, b >> 4], axis=-1).reshape(TB, 1024)
    q = ((zz >> 1) ^ -(zz & 1)).astype(jnp.float32)
    flat = q.reshape(-1)
    dummy = TB * 1024
    # esc_pos=None: esc_row already carries row*1024+pos packed (-1 pad)
    if esc_pos is None:
        eidx = jnp.where(esc_row >= 0, esc_row, dummy)
    else:
        eidx = jnp.where(esc_row >= 0, esc_row * 1024 + esc_pos, dummy)
    flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
    flat = flat.at[eidx].set(esc_val.astype(jnp.float32))
    q = flat[:dummy].reshape(TB, 1024)
    dq = q * _fast_cbrt(jnp.abs(q))                  # sign(q)|q|^{4/3}
    # scalefactor bytes: per-band -> per-coefficient via one-hot matmul
    # (exact: integer values <= 255, one nonzero product per output),
    # short-window rows overlaid from the pooled per-coefficient bytes
    kexp = jnp.dot(sfb.reshape(TB, 64).astype(jnp.float32), E_sf,
                   precision=jax.lax.Precision.HIGHEST)
    k = kexp.astype(jnp.int32)
    kidx = jnp.where(ssr >= 0, ssr, TB)
    k_ext = jnp.concatenate([k, jnp.zeros((1, 1024), k.dtype)])
    k = k_ext.at[kidx].set(ssf.astype(jnp.int32))[:TB]
    gain = _exp2_quarter(k - 100)
    spec = dq * gain
    # M/S per pair (per-coefficient bitmask, LSB-first)
    bits = msb.reshape(Tn, B // 2, 128, 1).astype(jnp.int32)
    ms = ((bits >> jnp.arange(8, dtype=jnp.int32)) & 1) \
        .reshape(Tn, B // 2, 1024) > 0
    sp = spec.reshape(Tn, B // 2, 2, 1024)
    mid, side = sp[:, :, 0], sp[:, :, 1]
    left = jnp.where(ms, mid + side, mid)
    right = jnp.where(ms, mid - side, side)
    spec = jnp.stack([left, right], axis=2).reshape(TB, 1024)
    # exception rows (host-prepared spectra; rare channels -> f32 wire)
    side_spec = side_q.astype(jnp.float32)
    sidx = jnp.where(side_row >= 0, side_row, TB)
    spec_ext = jnp.concatenate([spec, jnp.zeros((1, 1024), spec.dtype)])
    spec = spec_ext.at[sidx].set(side_spec)[:TB]
    # TNS rows: masked all-pole scans along frequency (after stereo and
    # side substitution, before the filterbank — fdk channel.cpp order)
    if tfi is not None:
        spec = apply_tns_zz(spec, tfi, tco, tdir, trow)
    # filterbank: whole-chunk IMDCT matmuls + one-hot window matmuls
    op = opx.reshape(TB).astype(jnp.int32)
    onehot = (op[:, None] == jnp.arange(16, dtype=jnp.int32)[None, :]) \
        .astype(jnp.float32)
    # magnitude-split IMDCT: tonal content concentrates ~1e7-magnitude
    # bins, and one f32 accumulation over them costs ~30 LSB of the 16-bit
    # output.  Zero entries accumulate exactly in the matmul, so summing the
    # few huge bins in their own pass keeps each pass's rounding at the
    # scale of its own terms (~10x less error for two matmuls).
    s_big = jnp.where(jnp.abs(spec) > 16384.0, spec, 0.0)
    s_small = spec - s_big
    x_long = (jnp.dot(s_small, M_long, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
              + jnp.dot(s_big, M_long, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST))
    x_long = x_long * jnp.dot(onehot, W,
                              precision=jax.lax.Precision.HIGHEST)
    xs = (jnp.dot(s_small.reshape(TB, 8, 128), M_short,
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
          + jnp.dot(s_big.reshape(TB, 8, 128), M_short,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST))  # (TB, 8, 256)
    oh4 = (jnp.bitwise_and(op, 3)[:, None]
           == jnp.arange(4, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    xs = xs * jnp.dot(oh4, SW.reshape(4, 8 * 256),
                      precision=jax.lax.Precision.HIGHEST) \
        .reshape(TB, 8, 256)
    x_short = jnp.zeros((TB, 2048), jnp.float32)
    for w in range(8):
        x_short = x_short.at[:, 448 + w * 128:448 + w * 128 + 256].add(
            xs[:, w])
    is_short = (op >> 2) == EIGHT_SHORT
    x = jnp.where(is_short[:, None], x_short, x_long).reshape(Tn, B, 2048)
    # overlap-add as a shifted slice: frame t's first half overlaps frame
    # t-1's second half (chronology runs along the T axis per column)
    prev = jnp.concatenate([overlap[None], x[:-1, :, 1024:]], axis=0)
    pcm = x[:, :, :1024] + prev
    return pcm, x[-1, :, 1024:]


def apply_tns_zz_reference(spec, tfi, tco, tdir, trow):
    """float64 numpy twin of apply_tns_zz (precision gate)."""
    for j in range(tfi.shape[0]):
        r = int(trow[j])
        if r < 0:
            continue
        x = spec[r]
        fid = tfi[j].astype(np.int32)
        for direction in (0, 1):
            idx_order = range(1024) if direction == 0 \
                else range(1023, -1, -1)
            hist = np.zeros(12)
            prev = -1                      # previous bin's fid, raw
            for i in idx_order:
                f = int(fid[i])
                act = f > 0 and int(tdir[j, f - 1]) == direction
                if act and f != prev:
                    hist[:] = 0.0
                y = x[i] - (tco[j, f - 1].astype(np.float64) @ hist
                            if act else 0.0)
                hist[1:] = hist[:-1]
                hist[0] = y
                x[i] = y
                prev = f
    return spec


def decode_chunk_zz_reference(q4, sfb, ssf, ssr, msb, opx,
                              esc_row, esc_pos, esc_val,
                              side_q, side_row, overlap, E_sf,
                              tfi=None, tco=None, tdir=None, trow=None):
    """float64 numpy reference of decode_chunk_zz — the precision gate the
    bench smoke checks the device program against (the device's f32 IMDCT
    accumulation is the only deviation)."""
    Tn, B, _ = sfb.shape
    TB = Tn * B
    bb = q4.reshape(TB, 512).astype(np.int32)
    zz = np.stack([bb & 15, bb >> 4], axis=-1).reshape(TB, 1024)
    q = ((zz >> 1) ^ -(zz & 1)).astype(np.float64)
    flat = q.reshape(-1)
    m = esc_row >= 0
    if esc_pos is None:
        flat[esc_row[m]] = esc_val[m]
    else:
        flat[esc_row[m] * 1024 + esc_pos[m]] = esc_val[m]
    q = flat.reshape(TB, 1024)
    k = (sfb.reshape(TB, 64).astype(np.float64)
         @ E_sf.astype(np.float64)).astype(np.int64)
    sel2 = ssr >= 0
    k[ssr[sel2]] = ssf[sel2]
    spec = (np.sign(q) * np.abs(q) ** (4.0 / 3.0)
            * np.exp2(0.25 * (k.astype(np.float64) - 100.0)))
    bits = ((msb.reshape(Tn, B // 2, 128, 1).astype(np.int32)
             >> np.arange(8)) & 1).reshape(Tn, B // 2, 1024)
    sp = spec.reshape(Tn, B // 2, 2, 1024)
    mid, side = sp[:, :, 0], sp[:, :, 1]
    left = np.where(bits > 0, mid + side, mid)
    right = np.where(bits > 0, mid - side, side)
    spec = np.stack([left, right], axis=2).reshape(TB, 1024)
    sel = side_row >= 0
    spec[side_row[sel]] = side_q[sel]
    if tfi is not None:
        spec = apply_tns_zz_reference(spec, tfi, tco, tdir, trow)
    W, SW = window_bank()
    ML = _imdct_matrix(2048).astype(np.float64)
    MS = _imdct_matrix(256).astype(np.float64)
    op = opx.reshape(TB).astype(int)
    x_long = spec @ ML * W[op]
    xs = np.einsum("twk,kn->twn", spec.reshape(TB, 8, 128), MS) * SW[op & 3]
    x_short = np.zeros((TB, 2048))
    for w in range(8):
        x_short[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
    x = np.where(((op >> 2) == EIGHT_SHORT)[:, None], x_short, x_long) \
        .reshape(Tn, B, 2048)
    prev = np.concatenate([overlap[None].astype(np.float64),
                           x[:-1, :, 1024:]], axis=0)
    return x[:, :, :1024] + prev, x[-1, :, 1024:]


@jax.jit
def filterbank_fast(spec_t, opidx_t, overlap, M_long, M_short, W, SW):
    """High-throughput filterbank: single matmul for the IMDCT of all
    frames, per-row window vectors, OLA under a cheap elementwise scan.

    spec_t (T, B, 1024) f32; opidx_t (T, B) i32; overlap (B, 1024) f32;
    M_long (1024, 2048); M_short (128, 256); W (16, 2048); SW (4, 8, 256).
    """
    Tn, B, _ = spec_t.shape
    flat = spec_t.reshape(Tn * B, 1024)
    x_long = jnp.dot(flat, M_long, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    x_long = x_long * W[opidx_t.reshape(-1)]
    # short path: 8 x 128-coefficient IMDCTs, windowed, overlap-assembled
    xs = jnp.dot(flat.reshape(Tn * B, 8, 128), M_short,
                 preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)       # (TB, 8, 256)
    xs = xs * SW[jnp.bitwise_and(opidx_t.reshape(-1), 3)]
    x_short = jnp.zeros((Tn * B, 2048), jnp.float32)
    for w in range(8):
        x_short = x_short.at[:, 448 + w * 128:448 + w * 128 + 256].add(
            xs[:, w])
    is_short = (jnp.right_shift(opidx_t.reshape(-1), 2) == EIGHT_SHORT)
    x = jnp.where(is_short[:, None], x_short, x_long).reshape(Tn, B, 2048)

    def step(ov, xt):
        return xt[:, 1024:], ov + xt[:, :1024]

    new_ov, pcm = jax.lax.scan(step, overlap, x)
    return pcm, new_ov


@jax.jit
def filterbank(spec_t, opidx_t, overlap, A_bank, B_bank):
    """spec_t (Tf, B, 1024) f32, opidx_t (Tf, B) i32 in [0,16),
    overlap (B, 1024) f32.  Returns (pcm (Tf, B, 1024), new_overlap)."""

    def step(ov, inp):
        spec, opidx = inp
        A = A_bank[opidx]             # (B, 1024, 1024)
        Bop = B_bank[opidx]
        first = jnp.einsum("bk,bkn->bn", spec, A,
                           preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        second = jnp.einsum("bk,bkn->bn", spec, Bop,
                            preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        return second, ov + first

    new_ov, pcm = jax.lax.scan(step, overlap, (spec_t, opidx_t))
    return pcm, new_ov


# ---------------------------------------------------------------------------
# host spectral prep
# ---------------------------------------------------------------------------

_POW43 = np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)


def dequantize(ch: ChannelData, rate_index: int) -> np.ndarray:
    """Quantized ints -> scaled spectrum, deinterleaved to window order
    (8x128 flattened for short frames)."""
    ics = ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    q = ch.quant.astype(np.int64)
    mag = np.where(np.abs(q) < 8192, _POW43[np.minimum(np.abs(q), 8191)],
                   np.abs(q).astype(np.float64) ** (4.0 / 3.0))
    spec_tx = np.sign(q) * mag
    out = np.zeros(1024)
    groups = ics.window_groups()
    if not ics.short:
        for k in range(ics.max_sfb):
            c = ch.band_cb[0, k]
            if c == 0 or c == 12 or c >= T.NOISE_CB:
                continue
            a, b = int(offsets[k]), int(offsets[k + 1])
            gain = 2.0 ** (0.25 * (ch.scalefactors[0, k] - T.SF_OFFSET))
            out[a:b] = spec_tx[a:b] * gain
        return out
    # short: transmission order [group][sfb][win][bins] -> [win][bins]
    pos = 0
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            width = int(offsets[k + 1] - offsets[k])
            c = ch.band_cb[g, k]
            gain = 2.0 ** (0.25 * (ch.scalefactors[g, k] - T.SF_OFFSET))
            for w in range(wins):
                if not (c == 0 or c == 12 or c >= T.NOISE_CB):
                    a = (win_base + w) * 128 + int(offsets[k])
                    out[a:a + width] = spec_tx[pos:pos + width] * gain
                pos += width
        win_base += wins
        pos = win_base * 128         # groups start at full window strides
    return out


# ---------------------------------------------------------------------------
# vectorized group prep (array-based path fed by the native unpacker)
# ---------------------------------------------------------------------------

_CONFIG_CACHE: dict = {}


def _layout(rate_index: int, seq: int, grouping: int, max_sfb: int):
    """Cached per-ICS-config index maps.

    Returns (perm_src, perm_dst, band_of_dst): transmission positions ->
    spectral positions plus the (g*15+k) band slot feeding each dest
    coefficient.
    """
    key = (rate_index, seq, grouping, max_sfb)
    hit = _CONFIG_CACHE.get(key)
    if hit is not None:
        return hit
    short = seq == EIGHT_SHORT
    ics = IcsInfo(seq, 0, max_sfb, grouping)
    offsets = T.sfb_offsets(rate_index, short)
    src, dst, band = [], [], []
    if not short:
        for k in range(max_sfb):
            a, b = int(offsets[k]), int(offsets[k + 1])
            src.extend(range(a, b))
            dst.extend(range(a, b))
            band.extend([k] * (b - a))
    else:
        pos = 0
        win_base = 0
        for g, wins in enumerate(ics.window_groups()):
            for k in range(max_sfb):
                width = int(offsets[k + 1] - offsets[k])
                for w in range(wins):
                    a = (win_base + w) * 128 + int(offsets[k])
                    src.extend(range(pos, pos + width))
                    dst.extend(range(a, a + width))
                    band.extend([g * 15 + k] * width)
                    pos += width
            win_base += wins
            pos = win_base * 128
    out = (np.asarray(src, np.int32), np.asarray(dst, np.int32),
           np.asarray(band, np.int32))
    _CONFIG_CACHE[key] = out
    return out


def prepare_group(batch: dict, nframes: int, channels: int,
                  prev_shape: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense-array spectral prep: dequant + scalefactors + PNS + M/S +
    intensity + TNS, vectorized across the whole group.

    Returns (specs (F, C, 1024) f32, opidx (F, C) i32); prev_shape (C,)
    is updated in place.
    """
    ri = batch["rate_index"]
    F, C = nframes, channels
    R = F * C
    ics = batch["ics"][:R]
    cb = batch["cb"][:R]
    sf = batch["sf"][:R]
    q = batch["quant"][:R].astype(np.int64)
    dq = np.sign(q) * np.where(
        np.abs(q) < 8192, _POW43[np.minimum(np.abs(q), 8191)],
        np.abs(q).astype(np.float64) ** (4.0 / 3.0))
    gains = np.exp2(0.25 * (sf.astype(np.float64) - T.SF_OFFSET))
    coded = (cb >= 1) & (cb <= 11)
    specs = np.zeros((R, 1024))
    # group rows by layout config for batched fancy-indexing
    keys = [(ri, int(ics[r][0]) if int(ics[r][0]) == EIGHT_SHORT else 0,
             int(ics[r][3]) if int(ics[r][0]) == EIGHT_SHORT else 0,
             int(ics[r][2])) for r in range(R)]
    by_cfg: dict = {}
    for r, k in enumerate(keys):
        by_cfg.setdefault(k, []).append(r)
    for (ri_, seq, grouping, max_sfb), rows in by_cfg.items():
        if max_sfb == 0:
            continue
        src, dst, band = _layout(ri_, seq, grouping, max_sfb)
        rows = np.asarray(rows)
        vals = dq[rows][:, src] * gains[rows][:, band]
        vals *= coded[rows][:, band]
        specs[rows[:, None], dst[None, :]] = vals
    # PNS
    noise_rows = np.where((cb == T.NOISE_CB).any(axis=1))[0]
    for r in noise_rows:
        seq = int(ics[r][0])
        src, dst, band = _layout(
            ri, seq if seq == EIGHT_SHORT else 0,
            int(ics[r][3]) if seq == EIGHT_SHORT else 0, int(ics[r][2]))
        sel = cb[r][band] == T.NOISE_CB
        if not sel.any():
            continue
        d = dst[sel]
        n = _pns_noise(int(r), int(d[0]), len(d))
        # normalise per band to energy 2^(sf/4)
        bids = band[sel]
        for b in np.unique(bids):
            m = bids == b
            seg = n[m]
            e = 2.0 ** (0.25 * sf[r][b])
            n[m] = seg * (e / np.sqrt(np.mean(seg * seg) + 1e-30))
        specs[r][d] = n
    # M/S + intensity (pairs)
    if C == 2:
        ms = batch["msmask"][:F]
        for f in range(F):
            rl, rr = f * 2, f * 2 + 1
            flag = ms[f][0]
            has_is = np.isin(cb[rr], (T.INTENSITY_CB, T.INTENSITY_CB2)).any()
            if (flag in (0, 0xFF)) and not has_is:
                continue
            seq = int(ics[rl][0])
            src, dst, band = _layout(
                ri, seq if seq == EIGHT_SHORT else 0,
                int(ics[rl][3]) if seq == EIGHT_SHORT else 0,
                int(ics[rl][2]))
            mask_band = np.zeros(120, bool)
            if flag == 2:
                mask_band[:] = True
            elif flag == 1:
                mask_band[:120] = ms[f][1:121] != 0
            cbr = cb[rr]
            is_band = np.isin(cbr, (T.INTENSITY_CB, T.INTENSITY_CB2))
            ms_sel = mask_band[band] & ~is_band[band] \
                & (cbr[band] != T.NOISE_CB)
            if flag in (1, 2) and ms_sel.any():
                d = dst[ms_sel]
                mid = specs[rl][d].copy()
                side = specs[rr][d].copy()
                specs[rl][d] = mid + side
                specs[rr][d] = mid - side
            if is_band.any():
                isel = is_band[band]
                d = dst[isel]
                bsel = band[isel]
                sign = np.where(cbr[bsel] == T.INTENSITY_CB, 1.0, -1.0)
                sign *= np.where(mask_band[bsel], -1.0, 1.0)
                scale = sign * 0.5 ** (0.25 * sf[rr][bsel])
                specs[rr][d] = specs[rl][d] * scale
    # TNS (native batch filter; python per-row fallback)
    if batch["tnsn"][:R].any():
        try:
            from ... import native
            if native.have_aac_unpack():
                native.aac_tns_group(specs, batch, R)
            else:
                raise ImportError
        except ImportError:
            for r in np.where(batch["tnsn"][:R].any(axis=1))[0]:
                _apply_tns_arrays(specs[r], batch, r, ri, ics[r])
    # opidx + prev_shape tracking
    opidx = np.zeros((F, C), np.int32)
    for f in range(F):
        for c in range(C):
            r = f * C + c
            opidx[f, c] = (int(ics[r][0]) * 4 + int(prev_shape[c]) * 2
                           + int(ics[r][1]))
            prev_shape[c] = int(ics[r][1])
    return (specs.reshape(F, C, 1024).astype(np.float32), opidx)


def _apply_tns_arrays(spec: np.ndarray, batch: dict, r: int, rate_index: int,
                      ics_row) -> None:
    short = int(ics_row[0]) == EIGHT_SHORT
    offsets = T.sfb_offsets(rate_index, short)
    nbands = len(offsets) - 1
    nwin = 8 if short else 1
    for w in range(nwin):
        n_filt = int(batch["tnsn"][r][w])
        base = w * 128 if short else 0
        bottom = nbands
        for fi in range(n_filt):
            length, order, direction = (
                int(x) for x in batch["tnsp"][r][w * 3 + fi])
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = min(int(offsets[min(top, nbands)]), 128 if short else 1024)
            if end <= start:
                continue
            lpc = _lattice_to_lpc(batch["tnsc"][r][w * 3 + fi][:order]
                                  .astype(np.float64)).tolist()
            seg = spec[base + start:base + end].copy()
            if direction:
                seg = seg[::-1].copy()
            vals = seg.tolist()
            state = [0.0] * len(lpc)
            for i, v in enumerate(vals):
                y = v - sum(a * s for a, s in zip(lpc, state))
                state = [y] + state[:-1]
                vals[i] = y
            out = np.asarray(vals)
            if direction:
                out = out[::-1]
            spec[base + start:base + end] = out


def _pns_noise(row: int, pos: int, n: int) -> np.ndarray:
    """Deterministic PNS noise: seeded per (row, band position) so the
    substitution is reproducible — identical streams decode identically
    call after call (the old module-global RNG state made the serving
    batch path non-deterministic run-to-run).  fdk equally uses a
    deterministic generator per channel (libAACdec block.cpp random
    vector); the exact sample values are decoder-specific — PNS
    conformance is an energy criterion (ISO 14496-3 4.6.13)."""
    return np.random.default_rng(
        (0x9A5 << 32) ^ (row * 2048 + pos)).standard_normal(n)


def apply_spectral_tools(frame: FrameData, specs: list[np.ndarray]) -> None:
    """In-place M/S, intensity, PNS over the dequantized spectra.

    Order per ISO 14496-3 4.6.7-4.6.9: PNS -> M/S -> intensity.
    """
    rate_index = frame.rate_index
    # PNS per channel
    for ch, spec in zip(frame.channels, specs):
        _apply_pns(ch, spec, rate_index)
    if len(frame.channels) != 2:
        return
    l_ch, r_ch = frame.channels
    l, r = specs
    ics = l_ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    mask = frame.ms_mask
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            a0, b0 = int(offsets[k]), int(offsets[k + 1])
            cb_r = r_ch.band_cb[g, k] if r_ch.band_cb is not None else 0
            for w in range(wins):
                base = (win_base + w) * 128 if ics.short else 0
                a, b = base + a0, base + b0
                if cb_r in (T.INTENSITY_CB, T.INTENSITY_CB2):
                    sign = 1.0 if cb_r == T.INTENSITY_CB else -1.0
                    if mask is not None and mask[g, k]:
                        sign = -sign
                    scale = sign * 0.5 ** (0.25 * r_ch.scalefactors[g, k])
                    r[a:b] = l[a:b] * scale
                elif mask is not None and mask[g, k] \
                        and cb_r not in (T.NOISE_CB,):
                    mid = l[a:b].copy()
                    side = r[a:b].copy()
                    l[a:b] = mid + side
                    r[a:b] = mid - side
        win_base += wins


def _apply_pns(ch: ChannelData, spec: np.ndarray, rate_index: int) -> None:
    ics = ch.ics
    if ch.band_cb is None or not (ch.band_cb == T.NOISE_CB).any():
        return
    offsets = T.sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            if ch.band_cb[g, k] != T.NOISE_CB:
                continue
            a0, b0 = int(offsets[k]), int(offsets[k + 1])
            energy = 2.0 ** (0.25 * ch.scalefactors[g, k])
            for w in range(wins):
                base = (win_base + w) * 128 if ics.short else 0
                n = _pns_noise(win_base + w, base + a0, b0 - a0)
                n *= energy / np.sqrt(np.mean(n * n) + 1e-30)
                spec[base + a0:base + b0] = n
        win_base += wins


def apply_tns(ch: ChannelData, spec: np.ndarray, rate_index: int) -> None:
    """TNS synthesis filtering (ISO 14496-3 4.6.9): all-pole filter across
    spectral bins per window."""
    if ch.tns is None:
        return
    ics = ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    nbands = len(offsets) - 1
    # TNS max band limits (ISO Table 4.139-ish); clamp to max_sfb range
    for w, filters in enumerate(ch.tns.filters):
        base = w * 128 if ics.short else 0
        bottom = nbands
        for (length, order, direction, coeffs) in filters:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = int(offsets[min(top, nbands)])
            end = min(end, 128 if ics.short else 1024)
            if end <= start:
                continue
            a = np.asarray(coeffs)
            seg = spec[base + start:base + end]
            if direction:
                seg = seg[::-1]
            # lattice-to-direct form conversion
            lpc = _lattice_to_lpc(a)
            state = np.zeros(len(lpc))
            for i in range(len(seg)):
                y = seg[i] - np.dot(lpc, state)
                state = np.roll(state, 1)
                state[0] = y
                seg[i] = y
            if direction:
                spec[base + start:base + end] = seg[::-1]
            else:
                spec[base + start:base + end] = seg


def _lattice_to_lpc(refl: np.ndarray) -> np.ndarray:
    a = np.zeros(0)
    for k in refl:
        a = np.concatenate([a + k * a[::-1], [k]]) if len(a) else np.array([k])
    return a
