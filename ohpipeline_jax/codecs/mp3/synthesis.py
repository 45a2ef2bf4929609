"""MP3 synthesis: requantization/stereo/alias host-side (vectorized),
hybrid filterbank (IMDCT + polyphase) as a batched jitted device program.

Math from ISO/IEC 11172-3 §2.4.3: requantize |x|^(4/3) with scalefactor
exponents, M/S and intensity stereo, short-block reorder, alias-reduction
butterflies, 36/12-point IMDCT with 4 window types (as 18->36 matmul
operators), frequency inversion, and the 32-band polyphase synthesis
(matrixing as a 32->64 matmul + the 512-tap Table B.3 window FIR) under a
lax.scan carrying the overlap and V-FIFO state.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import tables as T
from .bitstream import (BLOCK_NORMAL, BLOCK_SHORT, BLOCK_START, BLOCK_STOP,
                        PRETAB, FrameHeader, GranuleInfo)

# ---------------------------------------------------------------------------
# constants (formulas from the spec; no tabulated data needed)
# ---------------------------------------------------------------------------

_CS_CA_C = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                     -0.0037])
CS = (1.0 / np.sqrt(1.0 + _CS_CA_C ** 2))
CA = (_CS_CA_C / np.sqrt(1.0 + _CS_CA_C ** 2))


@functools.lru_cache(maxsize=None)
def _pow43_table() -> np.ndarray:
    """|x|^(4/3) for the full quantized-value range (linbits max 13 ->
    |x| <= 15 + 2^13 - 1 = 8206; libmad's powtab model).  Table lookup
    replaces the per-line float pow, which dominates requantize."""
    return np.arange(8208, dtype=np.float64) ** (4.0 / 3.0)


@functools.lru_cache(maxsize=None)
def _alias_indices() -> tuple[np.ndarray, np.ndarray]:
    """(31, 8) index pairs for the alias-reduction butterflies at every
    long-block subband boundary; disjoint, so fully vectorizable."""
    sb = np.arange(1, 32)[:, None] * 18
    i = np.arange(8)[None, :]
    return sb - 1 - i, sb + i


@functools.lru_cache(maxsize=None)
def _imdct_operators() -> np.ndarray:
    """(4, 18, 36) operators: windowed IMDCT per block type.

    Long (36-point): x[i] = sum_k X[k] cos(pi/72 (2i+1+18)(2k+1)), windowed
    per type; short: three 12-point IMDCTs windowed and overlapped into the
    36-sample frame at offsets 6/12/18.
    """
    ops = np.zeros((4, 18, 36))
    n_l = 36
    i = np.arange(n_l)
    k = np.arange(18)
    C36 = np.cos(np.pi / (2 * n_l) * (2 * i[None, :] + 1 + n_l / 2)
                 * (2 * k[:, None] + 1))          # (18, 36)
    win_normal = np.sin(np.pi / 36 * (i + 0.5))
    win_start = np.concatenate([
        np.sin(np.pi / 36 * (np.arange(0, 18) + 0.5)),
        np.ones(6),
        np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5)),
        np.zeros(6)])
    win_stop = np.concatenate([
        np.zeros(6),
        np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5)),
        np.ones(6),
        np.sin(np.pi / 36 * (np.arange(18, 36) + 0.5))])
    ops[BLOCK_NORMAL] = C36 * win_normal[None, :]
    ops[BLOCK_START] = C36 * win_start[None, :]
    ops[BLOCK_STOP] = C36 * win_stop[None, :]
    # short: 3 x 12-point, input lines k' = 3*k + w (after reorder the 18
    # coefficients of a subband hold [w0 k0..5, w1 k0..5, w2 k0..5]? no:
    # reorder produces per-subband lines ordered w-interleaved; we use
    # layout [k][w] flattened k-major (see reorder_short)
    n_s = 12
    ii = np.arange(n_s)
    kk = np.arange(6)
    C12 = np.cos(np.pi / (2 * n_s) * (2 * ii[None, :] + 1 + n_s / 2)
                 * (2 * kk[:, None] + 1))         # (6, 12)
    win_s = np.sin(np.pi / 12 * (ii + 0.5))
    short_op = np.zeros((18, 36))
    for w in range(3):
        off = 6 + w * 6
        for k6 in range(6):
            # coefficient index in our reordered layout: k-major [k][w]
            short_op[k6 * 3 + w, off:off + 12] += C12[k6] * win_s
    ops[BLOCK_SHORT] = short_op
    return ops


@functools.lru_cache(maxsize=None)
def _polyphase_matrix() -> np.ndarray:
    """(32, 64) matrixing: V[i] = sum_k N[i][k] S[k],
    N[i][k] = cos((16+i)(2k+1) pi / 64) (ISO Figure A.2)."""
    i = np.arange(64)
    k = np.arange(32)
    return np.cos((16 + i[None, :]) * (2 * k[:, None] + 1) * np.pi / 64)


@functools.lru_cache(maxsize=None)
def _window_matrix() -> np.ndarray:
    """(16, 32) -> D window taps arranged for the U-extraction pattern."""
    return T.SYNTHESIS_WINDOW.reshape(16, 32)


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------

def _linear_scalefac(g: GranuleInfo) -> np.ndarray:
    """Scalefactors in sfb-width-walk order (libmad's scalefac[39] model):
    LSF granules carry this natively; MPEG-1 structured arrays are
    flattened to it (mixed blocks: 8 long bands then short sfb 3+)."""
    if g.scalefac_lin is not None:
        lin = np.zeros(40, np.int32)
        lin[:39] = g.scalefac_lin
        return lin
    lin = np.zeros(40, np.int32)
    if g.window_switching and g.block_type == BLOCK_SHORT:
        if g.mixed_block:
            lin[:8] = g.scalefac_l[:8]
            lin[8:38] = g.scalefac_s[3:13].reshape(-1)
        else:
            lin[:39] = g.scalefac_s.reshape(-1)
    else:
        lin[:22] = g.scalefac_l
    return lin


def _sfbwidths(g: GranuleInfo, hdr: FrameHeader) -> np.ndarray:
    if g.window_switching and g.block_type == BLOCK_SHORT:
        return (T.sfb_mixed(hdr.sample_rate) if g.mixed_block
                else T.sfb_short_interleaved(hdr.sample_rate))
    return T.sfb_long(hdr.sample_rate)


def requantize(g: GranuleInfo, hdr: FrameHeader) -> np.ndarray:
    """Quantized ints -> float spectrum (576,), scalefactors applied,
    short blocks reordered to [subband][k][window] line order.

    Exponent model from ISO 11172-3 §2.4.3.4.7.1 (and 13818-3 for LSF):
    walk the applicable sfb-width table with linear scalefactors."""
    x = g.spectrum.astype(np.float64)
    mag = _pow43_table()[np.abs(g.spectrum)]
    base = 2.0 ** (0.25 * (g.global_gain - 210))
    sf_mult = 1.0 if g.scalefac_scale else 0.5
    lin = np.asarray(_linear_scalefac(g), np.float64)
    widths = _sfbwidths(g, hdr)
    # per-BAND exponents, exp2 over ~22 values then repeated to line
    # order (same values as the old per-line 576-wide 2.0**exps — the
    # exponent is constant within a band)
    w_int = widths.astype(np.int64)
    n = len(w_int)
    idx = np.arange(n)
    if g.window_switching and g.block_type == BLOCK_SHORT:
        if g.mixed_block:
            starts = np.cumsum(w_int) - w_int
            nlong = int((starts < 36).sum())   # long bands lead (<36)
        else:
            nlong = 0
        vals = np.empty(n)
        il = idx[:nlong]
        vals[:nlong] = -sf_mult * (lin[il]
                                   + g.preflag * PRETAB[np.minimum(il, 21)])
        win = np.arange(n - nlong) % 3         # window cycles per band
        vals[nlong:] = (-sf_mult * lin[nlong:n]
                        - 2.0 * np.asarray(g.subblock_gain,
                                           np.float64)[win])
    else:
        vals = -sf_mult * (lin[:n] + g.preflag * PRETAB[np.minimum(idx, 21)])
    rep = np.repeat(base * (2.0 ** vals), w_int)[:576]
    factors = np.full(576, base)               # tail past the last band
    factors[:len(rep)] = rep                   # keeps exps==0 semantics
    xr = np.sign(x) * mag * factors
    if g.window_switching and g.block_type == BLOCK_SHORT:
        xr = reorder_short_lin(xr, widths, g.mixed_block)
    return xr


def reorder_short_lin(xr: np.ndarray, widths: np.ndarray,
                      mixed: bool) -> np.ndarray:
    """Short-block reorder (ISO 2.4.3.5): from [sfb][window][line] to
    line order [subband 18-groups of [k][w]], walking the interleaved
    width table (mixed tables lead with the 36 long-band lines)."""
    out = xr.copy()
    start = 36 if mixed else 0
    sfbi = 0
    pos = 0
    if mixed:
        while pos < 36:
            pos += int(widths[sfbi])
            sfbi += 1
    base3 = start // 3
    freq = [base3] * 3
    w = 0
    while pos < 576 and sfbi < len(widths):
        width = int(widths[sfbi])
        for j in range(width):
            L = freq[w] + j
            dest = start + ((L - base3) // 6) * 18 + ((L - base3) % 6) * 3 \
                + w
            out[dest] = xr[pos + j]
        freq[w] += width
        pos += width
        sfbi += 1
        w = (w + 1) % 3
    return out


def stereo_process(hdr: FrameHeader, g_l: GranuleInfo, g_r: GranuleInfo,
                   xl: np.ndarray, xr_: np.ndarray) -> None:
    """M/S + intensity stereo in place (ISO 2.4.3.4)."""
    if hdr.ms_stereo:
        m = xl.copy()
        s = xr_.copy()
        inv = 1.0 / np.sqrt(2.0)
        if hdr.intensity_stereo:
            bound = _intensity_bound(hdr, g_r)
        else:
            bound = 576
        xl[:bound] = (m[:bound] + s[:bound]) * inv
        xr_[:bound] = (m[:bound] - s[:bound]) * inv
    if hdr.intensity_stereo:
        if hdr.lsf:
            _apply_intensity_lsf(hdr, g_r, xl, xr_)
        else:
            _apply_intensity(hdr, g_r, xl, xr_)


def _intensity_bound(hdr: FrameHeader, g_r: GranuleInfo) -> int:
    """First line of the intensity region = end of the right channel's
    data (rzero boundary rounded to a band edge)."""
    nz = np.nonzero(g_r.spectrum)[0]
    last = int(nz[-1]) + 1 if len(nz) else 0
    widths = T.sfb_long(hdr.sample_rate)
    edges = np.concatenate([[0], np.cumsum(widths)])
    for e in edges:
        if e >= last:
            return int(e)
    return 576


def _apply_intensity(hdr: FrameHeader, g_r: GranuleInfo, xl, xr_) -> None:
    bound = _intensity_bound(hdr, g_r)
    widths = T.sfb_long(hdr.sample_rate)
    edges = np.concatenate([[0], np.cumsum(widths)])
    for sfb in range(len(widths)):
        a, b = int(edges[sfb]), int(edges[sfb + 1])
        if a < bound:
            continue
        is_pos = int(g_r.scalefac_l[min(sfb, 21)])
        if is_pos >= 7:
            continue                     # illegal position: leave as-is
        ratio = np.tan(is_pos * np.pi / 12.0)
        l = xl[a:b].copy()
        xl[a:b] = l * (ratio / (1 + ratio)) if ratio >= 0 else l
        xr_[a:b] = l * (1 / (1 + ratio))


def _apply_intensity_lsf(hdr: FrameHeader, g_r: GranuleInfo, xl, xr_) -> None:
    """LSF intensity positions (ISO 13818-3 §2.4.3.2, libmad
    layer3.c:1437-1480): scale = io^((is_pos+1)//2) with io selected by
    the low bit of the right channel's scalefac_compress; odd positions
    swap the channels; the per-slen all-ones value is illegal.  Long
    blocks only (as the MPEG-1 path)."""
    bound = _intensity_bound(hdr, g_r)
    widths = T.sfb_long(hdr.sample_rate)
    edges = np.concatenate([[0], np.cumsum(widths)])
    lin = _linear_scalefac(g_r)
    ill = g_r.illegal_lin if g_r.illegal_lin is not None \
        else np.zeros(40, np.int32)
    step = 0.5 if (g_r.scalefac_compress & 1) else 0.25
    for sfb in range(len(widths)):
        a, b = int(edges[sfb]), int(edges[sfb + 1])
        if a < bound:
            continue
        if ill[min(sfb, 38)]:
            continue
        is_pos = int(lin[min(sfb, 38)])
        left = xl[a:b].copy()
        if is_pos == 0:
            xr_[a:b] = left
        else:
            opposite = left * 2.0 ** (-step * ((is_pos - 1) // 2 + 1))
            if is_pos & 1:
                xl[a:b] = opposite
                xr_[a:b] = left
            else:
                xr_[a:b] = opposite


def alias_reduce(xr: np.ndarray, block_type: int, mixed: bool) -> np.ndarray:
    """Alias-reduction butterflies (ISO 2.4.3.5) for long blocks."""
    if block_type == BLOCK_SHORT and not mixed:
        return xr
    nsb = 2 if (block_type == BLOCK_SHORT and mixed) else 32
    out = xr.copy()
    ia, ib = _alias_indices()
    ia, ib = ia[:nsb - 1], ib[:nsb - 1]
    a, b = out[ia], out[ib]
    out[ia] = a * CS - b * CA
    out[ib] = b * CS + a * CA
    return out


# ---------------------------------------------------------------------------
# device filterbank
# ---------------------------------------------------------------------------

@jax.jit
def hybrid_synthesis(xr_t, btype_t, overlap, vfifo, imdct_ops, poly_n,
                     wnd):
    """xr_t (Tg, B, 576) f32 spectra (granules in time order), btype_t
    (Tg, B, 32) i32 per-subband block type, overlap (B, 576), vfifo
    (B, 16, 64).  Returns pcm (Tg, B, 576), new states."""

    def granule(carry, inp):
        ov, vf = carry
        xr, btype = inp                        # (B,576), (B,32)
        B = xr.shape[0]
        bands = xr.reshape(B, 32, 18)
        ops = imdct_ops[btype]                 # (B, 32, 18, 36)
        x36 = jnp.einsum("bsk,bskn->bsn", bands, ops,
                         preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        ovb = ov.reshape(B, 32, 18)
        time_out = x36[:, :, :18] + ovb        # (B, 32, 18)
        new_ov = x36[:, :, 18:]
        # frequency inversion: odd subbands, odd time samples
        mask = (jnp.arange(32) % 2 == 1)[None, :, None] \
            & (jnp.arange(18) % 2 == 1)[None, None, :]
        time_out = jnp.where(mask, -time_out, time_out)

        # polyphase: 18 steps of 32 subband samples each
        S = time_out.transpose(0, 2, 1)        # (B, 18, 32)
        V = jnp.einsum("btk,ki->bti", S, poly_n,
                       preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)  # (B, 18, 64)

        def step(vf, vt):
            vf = jnp.concatenate([vt[:, None, :], vf[:, :-1]], axis=1)
            # U extraction: U[i*64+j] alternates halves of the fifo
            even = vf[:, 0::2, :32]            # (B, 8, 32)
            odd = vf[:, 1::2, 32:]             # (B, 8, 32)
            U = jnp.stack([even, odd], axis=2).reshape(-1, 16, 32)
            W = U * wnd[None]
            return vf, jnp.sum(W, axis=1)      # (B, 32)

        vf, pcm = jax.lax.scan(step, vf, V.transpose(1, 0, 2))
        pcm = pcm.transpose(1, 0, 2).reshape(B, 576)
        return (new_ov.reshape(B, 576), vf), pcm

    (ov, vf), pcm = jax.lax.scan(granule, (overlap, vfifo),
                                 (xr_t, btype_t))
    return pcm, ov, vf


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def hybrid_synthesis_parallel(xr_t, btype_t, overlap, vfifo, imdct_ops,
                              poly_n, wnd, n_real, bit_depth=16):
    """Scan-free formulation of hybrid_synthesis: the granule recurrence
    only ever references one-granule-old IMDCT tails (overlap-add) and a
    16-slot window of polyphase V vectors, so both are shifted gathers —
    everything becomes batched matmuls fully parallel over time (the
    accelerator-friendly layout; the scan version above is the streaming
    reference and remains bit-identical, see test_mp3 parallel test).

    xr_t (Tg, B, 576) may be zero-padded past n_real granules (static
    shape bucketing); returned states are taken at the n_real boundary
    via dynamic slicing so padding never advances the stream state.
    Returns pcm as int32 in native bit_depth range (clip/rint on
    device — one small download instead of a float plane)."""
    Tg, B = xr_t.shape[0], xr_t.shape[1]
    bands = xr_t.reshape(Tg, B, 32, 18)
    ops = imdct_ops[btype_t]                     # (Tg, B, 32, 18, 36)
    x36 = jnp.einsum("tbsk,tbskn->tbsn", bands, ops,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)  # (Tg,B,32,36)
    heads, tails = x36[..., :18], x36[..., 18:]
    prev_tails = jnp.concatenate(
        [overlap.reshape(1, B, 32, 18), tails[:-1]], axis=0)
    time_out = heads + prev_tails                # (Tg, B, 32, 18)
    new_ov = jax.lax.dynamic_slice_in_dim(
        tails, n_real - 1, 1, axis=0)[0].reshape(B, 576)
    mask = (jnp.arange(32) % 2 == 1)[None, None, :, None] \
        & (jnp.arange(18) % 2 == 1)[None, None, None, :]
    time_out = jnp.where(mask, -time_out, time_out)

    S = time_out.transpose(0, 3, 1, 2).reshape(Tg * 18, B, 32)
    V = jnp.einsum("tbk,ki->tbi", S, poly_n,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)  # (T, B, 64)
    # V history (newest-first fifo rows 0..14 = v[t-1]..v[t-15]) goes
    # oldest-first in front of the new slots
    Vfull = jnp.concatenate([vfifo[:, :15][:, ::-1].transpose(1, 0, 2),
                             V], axis=0)         # (15 + T, B, 64)
    T = Tg * 18
    # U rows at output slot t: U[2j] = V[t-2j][:32], U[2j+1] = V[t-2j-1][32:]
    # (the scan's even/odd fifo extraction); slot t lives at Vfull[15 + t]
    rows = []
    for j in range(8):
        rows.append(jax.lax.dynamic_slice_in_dim(
            Vfull, 15 - 2 * j, T, axis=0)[..., :32])
        rows.append(jax.lax.dynamic_slice_in_dim(
            Vfull, 14 - 2 * j, T, axis=0)[..., 32:])
    U = jnp.stack(rows, axis=2)                  # (T, B, 16, 32)
    pcm = jnp.sum(U * wnd[None, None], axis=2)   # (T, B, 32)
    pcm = pcm.reshape(Tg, 18, B, 32).transpose(0, 2, 1, 3) \
        .reshape(Tg, B, 576)
    # new fifo: rows 0..15 = v at slots n-1, n-2, ... n-16 (n = real slots)
    hist = jax.lax.dynamic_slice_in_dim(Vfull, 18 * n_real - 1, 16,
                                        axis=0)[::-1]
    new_vf = hist.transpose(1, 0, 2)             # (B, 16, 64)
    scale = jnp.float32(1 << (bit_depth - 1))
    lim = 1 << (bit_depth - 1)
    pcm_i = jnp.clip(jnp.rint(pcm * scale), -lim, lim - 1).astype(jnp.int32)
    return pcm_i, new_ov, new_vf


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def hybrid_synthesis_parallel_i16(q16, scl, btype_t, overlap, vfifo,
                                  imdct_ops, poly_n, wnd, n_real,
                                  bit_depth=16):
    """hybrid_synthesis_parallel behind an int16 spectrum wire (the
    multi-stream serving shape, codecs/mp3/serving.py): q16 (Tg, B, 576)
    int16 quantized spectra with per-granule-channel dequant scales scl
    (Tg, B) f32 (xr = q16 * scl), btype_t shipped as uint8.  Halves the
    spectra wire bytes vs f32 at ~3e-5 granule-relative error (same
    rationale as the Vorbis int16 spectrum wire in vorbis_jax)."""
    xr_t = q16.astype(jnp.float32) * scl[..., None]
    return hybrid_synthesis_parallel(
        xr_t, btype_t.astype(jnp.int32), overlap, vfifo,
        imdct_ops, poly_n, wnd, n_real, bit_depth)
