"""Device-side (jax) SBR reconstruction for groups of frames.

Device reformulation of the numpy SBR chain in ``sbr.py`` (itself
written from ISO 14496-3; behavioural parity target
thirdparty/fdk-aac/libSBRdec): the per-frame band loops become dense
masked tensor ops over a whole GROUP of frames at once.

Split of responsibilities:
  * host (this module's cond builder): bitstream-derived conditioning —
    per-envelope energy/noise targets mapped per bin, sine flags, slot
    -> envelope one-hot assignments, smoothing ratios, chirp factors,
    noise-table values and sine phase units (the tiny sequential
    counters stay in host state, mirroring sbr.py exactly);
  * device (jit): QMF analysis (two real matmuls over shifted block
    slices — no gather), HF generator (covariance einsums + static
    patch gather + chirped 2nd-order shifted adds), envelope adjustment
    (energy estimation, gain/limiter/boost, smoothing as a lax.scan
    over frames with a (2, M) carry), sine/noise injection, synthesis
    QMF (one matmul + 12 shifted adds for the overlap).

Sequential state that crosses group boundaries lives in
``SbrDeviceState`` (analysis history, 6-slot QMF history, synthesis
overlap tail, gain-smoothing carry); everything else is recomputed.

Reference stance: fdk libSBRdec qmf.cpp / lpp_tran.cpp / env_calc.cpp,
via the conformance-tested numpy implementation in sbr.py (the oracle
for tests/test_sbr_device.py).
"""

from __future__ import annotations

import numpy as np

from ... import enable_compile_cache
from . import sbr as SBR

MAXE = 8          # padded envelope slots per frame
NSL = 38          # buffered QMF slots per frame (6 history + 32)
def _jnp():
    import jax.numpy as jnp
    return jnp


class SbrStatic:
    """Per-header static conditioning (patch maps, limiter one-hots)."""

    def __init__(self, dec: "SBR.SbrDecoder"):
        ft, hdr = dec.ft, dec.header
        self.kx, self.M = ft.kx, ft.M
        kx, M = ft.kx, ft.M
        # patch source map: for k in [0,64): src[k] = low band p, or -1
        src = np.full(64, -1, np.int32)
        for (t0, s0, width) in ft.patches:
            for j in range(width):
                k, p = t0 + j, s0 + j
                if kx <= k < kx + M and 0 <= p < kx:
                    src[k] = p
        self.patch_src = src
        # noise band of each patched k (chirp selection)
        qi = np.zeros(64, np.int32)
        for k in range(64):
            qi[k] = min(max(int(np.searchsorted(ft.f_noise, k,
                                                side="right") - 1), 0),
                        ft.n_q - 1)
        self.patch_qi = qi
        # limiter-band one-hot (n_lim, M)
        nlim = len(ft.f_lim) - 1
        L = np.zeros((nlim, M), np.float32)
        for li in range(nlim):
            lo, hi = int(ft.f_lim[li]), int(ft.f_lim[li + 1])
            L[li, max(lo, 0):min(hi, M)] = 1.0
        self.limiter = L
        self.limgain = {0: 10 ** 0.15, 1: 10 ** 0.3,
                        2: 10 ** 0.45, 3: 1e10}[hdr.limiter_gains]
        self.interpol_freq = bool(hdr.interpol_freq)
        T = SBR.tables()
        self.K_ana = T["ana32"].astype(np.complex64)          # (32, 320)
        S = T["syn64"].astype(np.float32)                     # (64,2,768)
        self.syn_re, self.syn_im = S[:, 0], S[:, 1]
        self.n_q = ft.n_q
        # 512-entry V noise ROM + sine parity: the device regenerates
        # the per-slot noise/sine value planes from the counter seeds
        self.noise_tab_re = dec.noise_tab.real.astype(np.float32)
        self.noise_tab_im = dec.noise_tab.imag.astype(np.float32)
        self.inject_cal = np.float32(dec.INJECT_CAL)
        self.parity = np.where((np.arange(M) + kx) & 1, -1.0, 1.0) \
            .astype(np.float32)
        # padded band->bin one-hot maps: the cond wire ships per-BAND
        # env/noise rows and the device expands them to per-bin planes
        # with these static matmuls (a fraction of the upload bytes of
        # the expanded planes)
        mapL, mapH, mapN = _band_bin_maps(ft)
        self._band_maps = (mapL, mapH, mapN)   # host fills use the nb's
        self.nb_row = max(mapL.shape[0], mapH.shape[0])
        self.map_low = np.zeros((self.nb_row, M), np.float32)
        self.map_low[:mapL.shape[0]] = mapL
        self.map_high = np.zeros((self.nb_row, M), np.float32)
        self.map_high[:mapH.shape[0]] = mapH
        self.map_noise = mapN.astype(np.float32)       # (n_q, M)


def device_init_state(M: int) -> dict:
    """Fresh per-channel device-side SBR state (fdk delayed-output
    scheme): analysis window history, low-band timeline history + the
    transposer's 2-slot LPC prehistory, the adjusted 6-slot tail that
    rides into the next group's output, synthesis tail, and the gain/
    noise smoothing buffer."""
    return {"ana_hist": np.zeros(320, np.float32),
            "x_hist_re": np.zeros((6, 32), np.float32),
            "x_hist_im": np.zeros((6, 32), np.float32),
            "pre_re": np.zeros((2, 32), np.float32),
            "pre_im": np.zeros((2, 32), np.float32),
            "tail_r": np.zeros((6, M), np.float32),
            "tail_i": np.zeros((6, M), np.float32),
            "syn_state": np.zeros(704, np.float32),
            "filt": np.zeros((2, M), np.float32)}


class SbrFrameCond:
    """Stacked per-frame conditioning arrays for a group (numpy).

    This is the cond WIRE format: compact per-band rows and per-slot
    env indices; the device expands them to the per-bin planes the
    envelope adjuster consumes (band->bin one-hot matmuls against
    SbrStatic.map_low/high/noise, jax.nn.one_hot for the slot->env
    assignments).  The expanded planes would cost ~4x the bytes on the
    host->device copy."""

    def __init__(self, F: int, static: "SbrStatic"):
        z = np.zeros
        M, NB, NQ = static.M, static.nb_row, static.map_noise.shape[0]
        self.Erow = z((F, MAXE, NB), np.float32)       # per-band env
        self.Qrow = z((F, MAXE, NQ), np.float32)       # per-band noise
        self.fres = z((F, MAXE), np.float32)           # freq_res flag
        self.sine = z((F, MAXE, M), np.uint8)          # sine bins
        self.no_noise = z((F, MAXE), np.float32)       # 1.0 = suppress
        self.env_id = np.full((F, NSL), -1, np.int8)   # slot -> env
        self.prev_id = np.full((F, NSL), -1, np.int8)  # smoothing src
        self.r = z((F, NSL), np.float32)               # smoothing ratio
        self.last_env = z((F, MAXE), np.float32)       # carry pick
        # noise/sine value planes are generated ON DEVICE from these
        # counter seeds (one gather from the 512-entry ROM + phase
        # patterns) — uploading (F, NSL, M) float planes per channel
        # cost more wire than the whole PCM result
        self.noise_idx0 = z(1, np.int32)               # V-table seed
        self.sine_ph0 = z(1, np.int32)                 # phase seed
        self.bwk = z((F, 64), np.float32)              # chirp per band
        # fdk frame tiling (sbr_dec.cpp delayed-output scheme): slots
        # below 2*borders[0] belong to the previous frame's envelopes —
        # their adjusted values ride the scan carry; slots in
        # [2*borders[0], 2*borders[nEnv]) are patched+adjusted by THIS
        # frame
        self.carry_mask = z((F, NSL), np.float32)      # 1 = use carry


def _band_bin_maps(ft) -> tuple:
    """(map_low, map_high, map_noise): per-table (nb, M) float one-hot
    band->bin expansion matrices (row b_ covers bins
    [f[b_]-kx, f[b_+1]-kx) clamped to [0, M)) — the vectorized form of
    build_frame_cond's per-band slice fills."""
    kx, M = ft.kx, ft.M

    def mk(bands):
        nb = len(bands) - 1
        mp = np.zeros((nb, M), np.float64)
        for b_ in range(nb):
            lo = max(int(bands[b_]) - kx, 0)
            hi = min(int(bands[b_ + 1]) - kx, M)
            if hi > lo:
                mp[b_, lo:hi] = 1.0
        return mp

    return mk(ft.f_low), mk(ft.f_high), mk(ft.f_noise)


def _clamped_row(row: np.ndarray, nb: int) -> np.ndarray:
    """row resized to nb entries, repeating the last (the defensive
    min(b_, len(row)-1) indexing of the loop form)."""
    row = np.asarray(row, np.float64)
    if len(row) == nb:
        return row
    return row[np.minimum(np.arange(nb), len(row) - 1)]


def build_frame_cond(dec: "SBR.SbrDecoder", st: "SBR.SbrChannelState",
                     static: SbrStatic, datas: list, Es: list,
                     Qs: list, first: bool,
                     cond: "SbrFrameCond" = None) -> SbrFrameCond:
    """Mirror of sbr.py _reconstruct/_adjust conditioning for a group.
    Advances the host-side counters in ``st`` (bw, noise_index,
    sine_index, prev_harm_bins, prev_tran_env) exactly as the numpy
    path does.  Fills the COMPACT cond wire (per-band rows + per-slot
    env indices); the band->bin and one-hot expansions run on device
    (see SbrFrameCond)."""
    ft, hdr = dec.ft, dec.header
    kx, M = ft.kx, ft.M
    F = len(datas)
    if cond is None:
        cond = SbrFrameCond(F, static)
    cond.noise_idx0[0] = st.noise_index
    cond.sine_ph0[0] = st.sine_index
    map_low, map_high, map_noise = static._band_maps
    smooth = np.asarray(SBR._SMOOTH_FILTER)
    for f, (data, E, Q) in enumerate(zip(datas, Es, Qs)):
        g = data.grid
        # chirp factors (host recurrence, same as _reconstruct; level
        # from current+previous invf mode — SBR.map_invf_bw)
        nq = ft.n_q
        nbq = SBR.map_invf_bw(data.invf[:nq], st.prev_invf[:nq])
        st.prev_invf[:nq] = data.invf[:nq]
        prev = np.asarray(st.bw[:nq], np.float64)
        bw = np.where(nbq < prev, 0.75 * nbq + 0.25 * prev,
                      0.90625 * nbq + 0.09375 * prev)
        bw[bw < 0.015625] = 0.0
        bw = np.minimum(bw, 0.99609375)
        st.bw[:nq] = bw
        cond.bwk[f] = bw[static.patch_qi]
        # sine bookkeeping (host state, as in _adjust)
        sine_start = {}
        cur_bins = set()
        for b_ in range(ft.n_high):
            if data.add_harmonic[b_]:
                mid = (int(ft.f_high[b_])
                       + int(ft.f_high[b_ + 1])) // 2 - kx
                if 0 <= mid < M:
                    cur_bins.add(mid)
                    sine_start[mid] = 0 if mid in st.prev_harm_bins \
                        else max(g.tran_env, 0)
        prev_tran = st.prev_tran_env
        st.prev_harm_bins = cur_bins
        st.prev_tran_env = 0 if g.tran_env == g.n_env else -1
        cond.carry_mask[f, :max(0, min(g.t_env[0] * 2, NSL))] = 1.0
        last_processed = -1
        for e in range(min(g.n_env, MAXE)):
            # fdk buffer slot range = timeStep * borders (env_calc.cpp:
            # 621-622, delayed-output timeline; never truncated — slots
            # past 32 ride the scan carry into the next frame's output)
            sl0 = max(0, min(g.t_env[e] * 2, NSL))
            sl1 = max(sl0, min(g.t_env[e + 1] * 2, NSL))
            if sl1 <= sl0:
                continue
            fr = g.freq_res[e]
            mp = map_high if fr else map_low
            nb = mp.shape[0]
            ne = 0
            for q in range(g.n_noise):
                if g.t_noise[q] <= g.t_env[e] < g.t_noise[q + 1]:
                    ne = q
            cond.fres[f, e] = float(bool(fr))
            cond.Erow[f, e, :nb] = _clamped_row(E[e], nb)
            cond.Qrow[f, e] = _clamped_row(Q[ne], map_noise.shape[0])
            sine = np.zeros(M, bool)
            for mid, start in sine_start.items():
                if e >= start:
                    sine[mid] = True
            cond.sine[f, e] = sine
            no_noise = (e == g.tran_env or e == prev_tran)
            cond.no_noise[f, e] = float(no_noise)
            smooth_len = 0 if no_noise or hdr.smoothing_mode else 4
            sls = np.arange(sl0, sl1)
            cond.env_id[f, sls] = e
            kk = sls - sl0
            ksm = kk < smooth_len
            if ksm.any():
                cond.r[f, sls[ksm]] = smooth[kk[ksm]]
            # smoothing source: previous processed env in this
            # frame, else the cross-frame carry (index MAXE); the
            # very first env ever smooths against itself
            if last_processed >= 0:
                cond.prev_id[f, sls] = last_processed
            elif first and f == 0:
                cond.prev_id[f, sls] = e
            else:
                cond.prev_id[f, sls] = MAXE
            # noise/sine counters advance per active slot (M V-table
            # entries / one phase step each); the device regenerates the
            # value planes from the seeds recorded above
            nslots = sl1 - sl0
            st.noise_index = (st.noise_index + nslots * M) & 511
            st.sine_index = (st.sine_index + nslots) & 3
            last_processed = e
        if last_processed >= 0:
            cond.last_env[f, last_processed] = 1.0
    return cond


def device_decode_group(static: SbrStatic, pcm, cond: dict, state: dict,
                        ps_extras=None):
    """jit-able SBR group decode for one channel.

    pcm (F, 1024) f32 core samples; cond: stacked SbrFrameCond arrays;
    state: {ana_hist (320,), x_hist_re/im (6, 32), syn_state (704,),
    filt (2, M)}.  Returns (out (F*2048,), new_state); with
    ps_extras (any non-None) returns ((Zr, Zi), new_state) so the
    parametric-stereo stage can consume the QMF matrix."""
    import functools

    import jax
    jnp = _jnp()
    # every float32 contraction at full precision: a GPU would run
    # unqualified ones in TF32
    HI = jax.lax.Precision.HIGHEST
    ein = functools.partial(jnp.einsum, precision=HI)
    mm = functools.partial(jnp.matmul, precision=HI)
    F = pcm.shape[0]
    kx, M = static.kx, static.M
    NS = F * 32

    # ---- analysis QMF: shifted block slices + two real matmuls -------
    x = jnp.concatenate([state["ana_hist"], pcm.reshape(-1)])
    blocks = x.reshape(NS + 10, 32)
    win = jnp.concatenate([blocks[1 + j:1 + j + NS] for j in range(10)],
                          axis=1)                       # (NS, 320)
    Kre = jnp.asarray(static.K_ana.real.T)              # (320, 32)
    Kim = jnp.asarray(static.K_ana.imag.T)
    Xre = jnp.dot(win, Kre, precision=HI)
    Xim = jnp.dot(win, Kim, precision=HI)
    new_ana_hist = x[-320:]

    # ---- per-frame 38-slot buffers on the fdk delayed-output timeline
    # (sbr_dec.cpp): timeline = [6 carried slots | NS fresh slots]; the
    # window of frame f is timeline[f*32 : f*32+38], and the frame
    # patches + adjusts window slots [2*borders[0], 2*borders[nEnv])
    # exactly — consecutive frames tile the timeline.  The transposer's
    # LPC additionally sees a 2-slot prehistory (lpp_tran.cpp
    # lpcFilterStates), carried in state["pre_re"/"pre_im"].
    Xre_ext = jnp.concatenate([state["x_hist_re"], Xre])
    Xim_ext = jnp.concatenate([state["x_hist_im"], Xim])
    Pre_ext = jnp.concatenate([state["pre_re"], Xre_ext])  # (NS+8, 32)
    Pim_ext = jnp.concatenate([state["pre_im"], Xim_ext])
    idx = (jnp.arange(F)[:, None] * 32
           + jnp.arange(NSL)[None, :])                  # (F, 38)
    idx40 = (jnp.arange(F)[:, None] * 32
             + jnp.arange(NSL + 2)[None, :])            # (F, 40)
    Bre = Xre_ext[idx]                                  # (F, 38, 32)
    Bim = Xim_ext[idx]
    B40r = Pre_ext[idx40]                               # (F, 40, 32)
    B40i = Pim_ext[idx40]
    new_x_hist = (Xre_ext[-6:], Xim_ext[-6:])
    new_pre = (Xre_ext[-8:-6], Xim_ext[-8:-6])          # slots 30, 31

    # ---- HF generator ------------------------------------------------
    # covariance over prehistory + buffered slots per low band
    # (autoCorrLength window of lpp_tran.cpp:274, einsums)
    def phi(a_re, a_im, b_re, b_im):
        # sum over slots of a * conj(b): (F, 32) complex as two planes
        re = ein("fsk,fsk->fk", a_re, b_re) \
            + ein("fsk,fsk->fk", a_im, b_im)
        im = ein("fsk,fsk->fk", a_im, b_re) \
            - ein("fsk,fsk->fk", a_re, b_im)
        return re, im

    x0r, x0i = B40r[:, 2:], B40i[:, 2:]
    x1r, x1i = B40r[:, 1:-1], B40i[:, 1:-1]
    x2r, x2i = B40r[:, :-2], B40i[:, :-2]
    # np.vdot(a, b) = sum(conj(a) * b) = phi(b, a) in this convention
    p01r, p01i = phi(x0r, x0i, x1r, x1i)     # vdot(x1, x0)
    p02r, p02i = phi(x0r, x0i, x2r, x2i)     # vdot(x2, x0)
    p11r, _ = phi(x1r, x1i, x1r, x1i)
    p12r, p12i = phi(x1r, x1i, x2r, x2i)     # vdot(x2, x1)
    p22r, _ = phi(x2r, x2i, x2r, x2i)
    d = p22r * p11r - (p12r ** 2 + p12i ** 2) / 1.000001
    safe_d = jnp.where(jnp.abs(d) > 1e-9, d, 1.0)
    a1r = (p01r * p12r - p01i * p12i - p02r * p11r) / safe_d
    a1i = (p01i * p12r + p01r * p12i - p02i * p11r) / safe_d
    a1r = jnp.where(jnp.abs(d) > 1e-9, a1r, 0.0)
    a1i = jnp.where(jnp.abs(d) > 1e-9, a1i, 0.0)
    safe_p11 = jnp.where(p11r > 1e-9, p11r, 1.0)
    # a0 = -(phi01 + a1 * conj(phi12)) / phi11
    a0r = -(p01r + a1r * p12r + a1i * p12i) / safe_p11
    a0i = -(p01i + a1i * p12r - a1r * p12i) / safe_p11
    a0r = jnp.where(p11r > 1e-9, a0r, 0.0)
    a0i = jnp.where(p11r > 1e-9, a0i, 0.0)
    big = (jnp.sqrt(a0r ** 2 + a0i ** 2) >= 4.0) \
        | (jnp.sqrt(a1r ** 2 + a1i ** 2) >= 4.0)
    a0r = jnp.where(big, 0.0, a0r)
    a0i = jnp.where(big, 0.0, a0i)
    a1r = jnp.where(big, 0.0, a1r)
    a1i = jnp.where(big, 0.0, a1i)

    # patch: for each k with src[k] >= 0, chirped 2nd-order filter of
    # the source column; low bands pass through, unpatched high = 0
    src = jnp.asarray(np.where(static.patch_src >= 0,
                               static.patch_src, 0))
    is_patch = jnp.asarray((static.patch_src >= 0)
                           .astype(np.float32))         # (64,)
    bwk = cond["bwk"]                                   # (F, 64)
    sa0r = jnp.take(a0r, src, axis=1) * bwk             # (F, 64)
    sa0i = jnp.take(a0i, src, axis=1) * bwk
    sa1r = jnp.take(a1r, src, axis=1) * bwk * bwk
    sa1i = jnp.take(a1i, src, axis=1) * bwk * bwk
    xsr = jnp.take(B40r, src, axis=2)                   # (F, 40, 64)
    xsi = jnp.take(B40i, src, axis=2)
    x0sr, x0si = xsr[:, 2:], xsi[:, 2:]                 # slot i
    x1sr, x1si = xsr[:, 1:-1], xsi[:, 1:-1]             # slot i-1
    x2sr, x2si = xsr[:, :-2], xsi[:, :-2]               # slot i-2
    hfr = x0sr + (sa0r[:, None, :] * x1sr - sa0i[:, None, :] * x1si) \
        + (sa1r[:, None, :] * x2sr - sa1i[:, None, :] * x2si)
    hfi = x0si + (sa0r[:, None, :] * x1si + sa0i[:, None, :] * x1sr) \
        + (sa1r[:, None, :] * x2si + sa1i[:, None, :] * x2sr)
    # assemble 64-band buffer: low bands raw, patched bands hf
    low_pad = jnp.concatenate(
        [Bre, jnp.zeros((F, NSL, 32), Bre.dtype)], axis=2)
    low_pad_i = jnp.concatenate(
        [Bim, jnp.zeros((F, NSL, 32), Bim.dtype)], axis=2)
    Yre = jnp.where(is_patch[None, None, :] > 0, hfr, low_pad)
    Yim = jnp.where(is_patch[None, None, :] > 0, hfi, low_pad_i)

    # ---- expand the compact cond wire to per-bin planes --------------
    # (band rows -> bins via the static one-hot maps; slot env indices
    # -> one-hot assignment matrices; -1 rows become all-zero)
    mapL = jnp.asarray(static.map_low)                  # (NB, M)
    mapH = jnp.asarray(static.map_high)
    mapN = jnp.asarray(static.map_noise)                # (NQ, M)
    fres = cond["fres"][..., None]                      # (F, E, 1)
    Erow = cond["Erow"]
    Emap = (ein("feb,bm->fem", Erow, mapL) * (1.0 - fres)
            + ein("feb,bm->fem", Erow, mapH) * fres)
    Qmap = ein("feq,qm->fem", cond["Qrow"], mapN)
    sine_bins = cond["sine"].astype(jnp.float32)        # (F, E, M)

    def sine_in_band(mp):
        hasb = (ein("bm,fem->feb", mp, sine_bins)
                > 0).astype(jnp.float32)
        return (ein("feb,bm->fem", hasb, mp)
                > 0).astype(jnp.float32)

    sine_band = jnp.where(fres > 0, sine_in_band(mapH),
                          sine_in_band(mapL))
    env_id = cond["env_id"].astype(jnp.int32)           # (F, 38)
    A = jax.nn.one_hot(env_id, MAXE, dtype=jnp.float32)
    Aprev = jax.nn.one_hot(cond["prev_id"].astype(jnp.int32),
                           MAXE + 1, dtype=jnp.float32)
    active = (env_id >= 0).astype(jnp.float32)          # (F, 38)

    # ---- envelope adjustment ----------------------------------------
    # the transposer writes only the frame's own slots [2*borders[0],
    # 2*borders[nEnv]); the rest keep the unpatched buffer.  The tail
    # past the last border rides into the next frame, which uses it when
    # its first border starts later (a splice between streams)
    live = active[:, :, None] > 0
    Er = jnp.where(live, Yre, low_pad)[:, :, kx:kx + M]
    Ei = jnp.where(live, Yim, low_pad_i)[:, :, kx:kx + M]
    Eslot = Er * Er + Ei * Ei                           # (F, 38, M)
    counts = jnp.maximum(A.sum(axis=1), 1.0)            # (F, MAXE)
    Ecurr = ein("fse,fsm->fem", A, Eslot) / counts[:, :, None]
    if not static.interpol_freq:
        def band_avg(mp):
            bsum = ein("bm,fem->feb", mp, Ecurr)
            bcnt = jnp.maximum(mp.sum(axis=1), 1.0)     # (NB,)
            ea = ein("feb,bm->fem", bsum / bcnt, mp)
            cov = mp.sum(axis=0) > 0                    # (M,)
            return jnp.where(cov[None, None, :], ea, Ecurr)

        Ecurr = jnp.where(fres > 0, band_avg(mapH), band_avg(mapL))
    qfac = Qmap / (1.0 + Qmap)
    Ecs = jnp.maximum(Ecurr, 1e-12)
    # calcSubbandGain rules (env_calc.cpp:1608-1701): the (1+Q)
    # divisor drops on no-noise (attack) envelopes — no noise will be
    # injected, the gained signal alone carries the reference energy
    nn = cond["no_noise"][:, :, None]                   # (F, E, 1)
    gain = jnp.where(sine_band > 0,
                     jnp.sqrt(Emap * qfac / Ecs),
                     jnp.sqrt(Emap / (jnp.where(nn > 0, 1.0,
                                                1.0 + Qmap) * Ecs)))
    noise_lvl = jnp.sqrt(Emap * qfac)
    sine_lvl = jnp.where(sine_bins > 0,
                         jnp.sqrt(Emap / (1.0 + Qmap)), 0.0)
    # limiter per limiter band (static one-hot matmuls)
    L = jnp.asarray(static.limiter)                     # (nlim, M)
    Esum = ein("lm,fem->fel", L, Emap)
    Csum = ein("lm,fem->fel", L, Ecurr)
    gmax_l = jnp.minimum(
        static.limgain * jnp.sqrt((Esum + 1e-12) / (Csum + 1e-12)),
        1e10)                                           # (F, E, nlim)
    gmax = ein("fel,lm->fem", gmax_l, L)
    gmax = jnp.where(L.sum(axis=0)[None, None, :] > 0, gmax, 1e10)
    ratio = jnp.minimum(1.0, gmax / jnp.maximum(gain, 1e-12))
    noise_lvl = noise_lvl * ratio
    gain = jnp.minimum(gain, gmax)
    # boost accumulator (env_calc.cpp:786-805): per bin the sine energy
    # if a sine sits there, else (non-attack) the noise energy
    achieved_m = (Ecurr * gain ** 2
                  + jnp.where(sine_lvl > 0, 0.0, noise_lvl ** 2)
                  * (1.0 - nn)
                  + sine_lvl ** 2)
    ach_l = ein("lm,fem->fel", L, achieved_m)
    boost_l = jnp.minimum(
        jnp.sqrt(Esum / jnp.maximum(ach_l, 1e-12)), 1.584893192)
    boost = ein("fel,lm->fem", boost_l, L)
    boost = jnp.where(L.sum(axis=0)[None, None, :] > 0, boost, 1.0)
    gain = gain * boost
    noise_lvl = noise_lvl * boost
    sine_lvl = sine_lvl * boost

    # ---- per-slot smoothing + injection (scan over frames) ----------
    # the scan carries (filt smoothing state, the adjusted 6-slot tail):
    # window slots below 2*borders[0] belong to the PREVIOUS frame's
    # envelopes — their final values ride the tail carry (fdk overlap
    # update, sbr_dec.cpp:745-755); everything from 2*borders[0] on is
    # this frame's own patch + adjustment
    def frame_step(carry, inp):
        filt, tail_r, tail_i = carry                    # (2,M),(6,M)x2
        (Gf, Nf, Sf, Sbins, Af, Apf, rf, actf, lastf,
         nre, nim, sre, sim, er, ei, cmask) = inp
        head_r = jnp.concatenate(
            [tail_r, jnp.zeros((NSL - 6, tail_r.shape[1]), tail_r.dtype)])
        head_i = jnp.concatenate(
            [tail_i, jnp.zeros((NSL - 6, tail_i.shape[1]), tail_i.dtype)])
        cm = cmask[:, None]
        er = jnp.where(cm > 0, head_r, er)
        ei = jnp.where(cm > 0, head_i, ei)
        Gext = jnp.concatenate([Gf, filt[0][None]])     # (MAXE+1, M)
        Next = jnp.concatenate([Nf, filt[1][None]])
        Gcur = mm(Af, Gf)                               # (38, M)
        Ncur = mm(Af, Nf)
        Gprev = mm(Apf, Gext)
        Nprev = mm(Apf, Next)
        g_sl = rf[:, None] * Gprev + (1 - rf[:, None]) * Gcur
        n_sl = rf[:, None] * Nprev + (1 - rf[:, None]) * Ncur
        s_sl = mm(Af, Sf)                               # sine, no smooth
        sine_mask = mm(Af, Sbins)                       # sine bins/slot
        out_r = er * g_sl + nre * n_sl * (1 - sine_mask) \
            + sre * s_sl
        out_i = ei * g_sl + nim * n_sl * (1 - sine_mask) \
            + sim * s_sl
        act = actf[:, None]
        out_r = jnp.where(act > 0, out_r, er)
        out_i = jnp.where(act > 0, out_i, ei)
        new_gain = mm(lastf, Gf)
        new_noise = mm(lastf, Nf)
        has_env = lastf.sum() > 0
        filt = jnp.where(has_env,
                         jnp.stack([new_gain, new_noise]), filt)
        return (filt, out_r[32:], out_i[32:]), \
            (out_r[:32], out_i[:32])

    # ---- regenerate noise/sine value planes from the counter seeds --
    # (host advances st.noise_index by M and st.sine_index by 1 per
    # active slot, in (frame, slot) order; cumsum reproduces the walk)
    act_flat = active.reshape(-1)                       # (F*NSL,)
    k_ord = (jnp.cumsum(act_flat) - act_flat).astype(jnp.int32)
    nstart = cond["noise_idx0"][0] + k_ord * M          # (F*NSL,)
    nidx = (nstart[:, None] + 1 + jnp.arange(M)[None, :]) & 511
    nre = jnp.asarray(static.noise_tab_re)[nidx].reshape(F, NSL, M)
    nim = jnp.asarray(static.noise_tab_im)[nidx].reshape(F, NSL, M)
    # zero for inactive slots and inside no-noise envelopes (the host
    # path skips writing those, but still advances the counters)
    nn_slot = ein("fse,fe->fs", A, cond["no_noise"])
    nmask = (act_flat.reshape(F, NSL) * (1.0 - nn_slot))[..., None]
    nre = nre * nmask
    nim = nim * nmask
    ph = (cond["sine_ph0"][0] + k_ord) & 3              # (F*NSL,)
    ph_re = jnp.where(ph == 0, 1.0,
                      jnp.where(ph == 2, -1.0, 0.0)).reshape(F, NSL)
    ph_im = jnp.where(ph == 1, 1.0,
                      jnp.where(ph == 3, -1.0, 0.0)).reshape(F, NSL)
    sine_slot = ein("fse,fem->fsm", A, sine_bins)
    par = jnp.asarray(static.parity)
    # sine planes carry the injection calibration (see
    # SbrDecoder.INJECT_CAL; the noise ROM already carries it) — the
    # boost bookkeeping above stays in uncalibrated energy units
    sre = ph_re[..., None] * sine_slot * static.inject_cal
    sim = ph_im[..., None] * par[None, None, :] * sine_slot \
        * static.inject_cal
    inputs = (gain, noise_lvl, sine_lvl, sine_bins, A, Aprev,
              cond["r"], active, cond["last_env"],
              nre, nim, sre, sim, Er, Ei, cond["carry_mask"])
    import jax as _jax
    (filt, tail_r, tail_i), (Or, Oi) = _jax.lax.scan(
        frame_step, (state["filt"], state["tail_r"], state["tail_i"]),
        inputs)

    # ---- synthesis QMF over the frame-output slots [0, 32) ----------
    # (the fdk delayed-output timeline: timeline slots [0, NS) are this
    # group's output; the adjusted tail [NS, NS+6) carries forward)
    out_lo_r = Xre_ext[:NS]                             # (NS, 32)
    out_lo_i = Xim_ext[:NS]
    Omr = Or.reshape(NS, M)
    Omi = Oi.reshape(NS, M)
    hi_z = jnp.zeros((NS, 64 - kx - M))
    Zr = jnp.concatenate([out_lo_r[:, :kx], Omr, hi_z], axis=1)
    Zi = jnp.concatenate([out_lo_i[:, :kx], Omi, hi_z], axis=1)
    if ps_extras is not None:
        # hand the adjusted QMF matrix to the PS stage; the PS caller
        # owns the (per-output-channel) synthesis states
        new_state = {"ana_hist": new_ana_hist,
                     "x_hist_re": new_x_hist[0],
                     "x_hist_im": new_x_hist[1],
                     "pre_re": new_pre[0], "pre_im": new_pre[1],
                     "tail_r": tail_r, "tail_i": tail_i,
                     "syn_state": state["syn_state"],
                     "filt": filt}
        return (Zr, Zi), new_state
    out, new_syn = synthesize_slots(static, Zr, Zi, state["syn_state"])
    new_state = {"ana_hist": new_ana_hist,
                 "x_hist_re": new_x_hist[0],
                 "x_hist_im": new_x_hist[1],
                 "pre_re": new_pre[0], "pre_im": new_pre[1],
                 "tail_r": tail_r, "tail_i": tail_i,
                 "syn_state": new_syn,
                 "filt": filt}
    return out, new_state


def synthesize_slots(static: SbrStatic, Zr, Zi, syn_state):
    """64-band synthesis QMF for a run of slots: one matmul + 12
    shifted adds for the 768-sample per-slot responses."""
    import jax as _jax
    jnp = _jnp()
    NS = Zr.shape[0]
    contrib = jnp.dot(Zr, jnp.asarray(static.syn_re),
                      precision=_jax.lax.Precision.HIGHEST) \
        + jnp.dot(Zi, jnp.asarray(static.syn_im),
                  precision=_jax.lax.Precision.HIGHEST)  # (NS, 768)
    z12 = contrib.reshape(NS, 12, 64)
    acc = jnp.zeros((NS + 12, 64), contrib.dtype)
    for j in range(12):
        acc = acc.at[j:j + NS].add(z12[:, j])
    out = acc.reshape(-1)[:NS * 64 + 704]
    out = out.at[:704].add(syn_state)
    return out[:NS * 64], out[NS * 64:NS * 64 + 704]


_CORE_CONSTS = None


def _core_consts() -> tuple:
    """f32 LC filterbank constants for the fused core IMDCT (shared
    with synthesis.py so both paths window identically)."""
    global _CORE_CONSTS
    if _CORE_CONSTS is None:
        from . import synthesis as SYN
        W, SW = SYN.window_bank()
        _CORE_CONSTS = (SYN._imdct_matrix(2048).astype(np.float32),
                        SYN._imdct_matrix(256).astype(np.float32),
                        np.asarray(W, np.float32),
                        np.asarray(SW, np.float32))
    return _CORE_CONSTS


def core_imdct_device(specs, opidx, core_ov):
    """LC core filterbank on device for one channel: specs (F, 1024)
    f32 prepared spectra, opidx (F,) i32 operator indices, core_ov
    (1024,) f32 overlap tail.  Returns (pcm (F, 1024), new_ov).

    Same math as _core_float_from_specs / SYN.filterbank_fast (IMDCT as
    one matmul, per-row window select, overlap-add).  The OLA is a
    shift, not a scan: frame f's output needs only frame f-1's tail.
    Fusing this into the SBR program ships spectra instead of PCM —
    identical wire bytes (1024 f32 per frame either way) but the host
    sheds the core matmul (fdk runs the same chain in
    libAACdec block.cpp CBlock_FrequencyToTime before libSBRdec)."""
    import jax
    jnp = _jnp()
    MLc, MSc, Wc, SWc = _core_consts()
    ML, MS = jnp.asarray(MLc), jnp.asarray(MSc)
    W, SW = jnp.asarray(Wc), jnp.asarray(SWc)
    F = specs.shape[0]
    HI = jax.lax.Precision.HIGHEST
    x_long = jnp.dot(specs, ML, precision=HI) * W[opidx]
    xs = jnp.dot(specs.reshape(F, 8, 128), MS, precision=HI) \
        * SW[jnp.bitwise_and(opidx, 3)]
    x_short = jnp.zeros((F, 2048), jnp.float32)
    for w in range(8):
        x_short = x_short.at[:, 448 + w * 128:448 + w * 128 + 256] \
            .add(xs[:, w])
    is_short = (jnp.right_shift(opidx, 2) == 2)         # EIGHT_SHORT
    x = jnp.where(is_short[:, None], x_short, x_long)
    prev_tail = jnp.concatenate([core_ov[None], x[:-1, 1024:]])
    return x[:, :1024] + prev_tail, x[-1, 1024:]


def _static_key(static: "SbrStatic") -> tuple:
    return (static.kx, static.M, static.n_q, float(static.limgain),
            bool(static.interpol_freq), static.patch_src.tobytes(),
            static.patch_qi.tobytes(), static.limiter.tobytes(),
            static.map_low.tobytes(), static.map_high.tobytes(),
            static.map_noise.tobytes())


_GROUP_FNS: dict = {}


def _group_fn(static: "SbrStatic"):
    """Shared jitted group program keyed on the header-derived static
    config, so fresh runner/codec instances reuse compiled code
    instead of recompiling per stream."""
    key = ("sbr", _static_key(static))
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        enable_compile_cache()
        fn = jax.jit(lambda pcm, cond, st: device_decode_group(
            static, pcm, cond, st))
        _GROUP_FNS[key] = fn
    return fn


def _group_fn_multi(static: "SbrStatic"):
    """All channels of a group in ONE device call: vmap the
    single-channel program over a leading channel axis and round to
    the pipeline's int32 range on device (one small download per
    group instead of per-channel float planes)."""
    key = ("sbr-multi", _static_key(static))
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp
        enable_compile_cache()

        def run(pcm, cond, st):
            out, new_st = jax.vmap(
                lambda p, c, s: device_decode_group(static, p, c, s)
            )(pcm, cond, st)
            # int16 on device: halves the download (the pipeline range
            # fits; the host widens to int32 for free)
            pcm_i = jnp.clip(jnp.rint(out), -32768, 32767) \
                .astype(jnp.int16)
            return pcm_i, new_st

        fn = jax.jit(run)
        _GROUP_FNS[key] = fn
    return fn


def _group_fn_multi_spec(static: "SbrStatic"):
    """_group_fn_multi with the LC core IMDCT fused in: inputs are
    prepared spectra + operator indices per channel instead of PCM,
    plus the carried (C, 1024) core overlap."""
    key = ("sbr-multi-spec", _static_key(static))
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp
        enable_compile_cache()

        def run(specs, ops, cond, st, core_ov):
            pcm, new_ov = jax.vmap(core_imdct_device)(specs, ops,
                                                      core_ov)
            out, new_st = jax.vmap(
                lambda p, c, s: device_decode_group(static, p, c, s)
            )(pcm, cond, st)
            pcm_i = jnp.clip(jnp.rint(out), -32768, 32767) \
                .astype(jnp.int16)
            return pcm_i, new_st, new_ov

        fn = jax.jit(run)
        _GROUP_FNS[key] = fn
    return fn


def _group_fn_multi_zz(static: "SbrStatic"):
    """_group_fn_multi_spec with the LC core decoded from the zigzag-
    nibble wire on device (synthesis.decode_chunk_zz: dequant, M/S,
    TNS, IMDCT, overlap-add) — the multi-stream serving shape, where
    shipping f32 spectra (incompressible mantissas) dominated the
    group wire."""
    key = ("sbr-multi-zz", _static_key(static))
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        from . import synthesis as SYN
        enable_compile_cache()

        def run(q4, sfb, ssf, ssr, msb, opx, epak, eva2, side, srow,
                ml, ms_, w_, sw_, esf, tfi, tco, tdir, trow,
                cond, st, core_ov):
            pcm, new_ov = SYN.decode_chunk_zz(
                q4, sfb, ssf, ssr, msb, opx, epak, None, eva2,
                side, srow, core_ov, ml, ms_, w_, sw_, esf,
                tfi, tco, tdir, trow)                # (G, SC, 1024)
            pcmT = jnp.transpose(pcm, (1, 0, 2))     # (SC, G, 1024)
            out, new_st = jax.vmap(
                lambda p, c, s: device_decode_group(static, p, c, s)
            )(pcmT, cond, st)
            pcm_i = jnp.clip(jnp.rint(out), -32768, 32767) \
                .astype(jnp.int16)
            return pcm_i, new_st, new_ov

        fn = jax.jit(run)
        _GROUP_FNS[key] = fn
    return fn


def _group_fn_ps_spec(static: "SbrStatic", ps_static: "PsStatic"):
    """_group_fn_ps with the (mono) LC core IMDCT fused in."""
    key = ("ps-spec", _static_key(static))
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp
        enable_compile_cache()

        def run(specs, ops, cond, st, pst, synr, H, core_ov):
            pcm, new_ov = core_imdct_device(specs, ops, core_ov)
            out, new_st, new_ps, new_synr = device_decode_group_ps(
                static, ps_static, pcm, cond, st, pst, synr, H)
            pcm_i = jnp.clip(jnp.rint(out), -32768, 32767) \
                .astype(jnp.int16)
            return pcm_i, new_st, new_ps, new_synr, new_ov

        fn = jax.jit(run)
        _GROUP_FNS[key] = fn
    return fn


def _group_fn_ps(static: "SbrStatic", ps_static: "PsStatic"):
    key = ("ps", _static_key(static))   # PsStatic is ROM-derived
    fn = _GROUP_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp
        enable_compile_cache()

        def run(pcm, cond, st, pst, synr, H):
            out, new_st, new_ps, new_synr = device_decode_group_ps(
                static, ps_static, pcm, cond, st, pst, synr, H)
            pcm_i = jnp.clip(jnp.rint(out), -32768, 32767) \
                .astype(jnp.int16)
            return pcm_i, new_st, new_ps, new_synr

        fn = jax.jit(run)
        _GROUP_FNS[key] = fn
    return fn


class SbrDeviceRunner:
    """Wraps an SbrDecoder to decode groups of frames on device for one
    or two channels.  Parsing, dequantisation and conditioning stay on
    the host (sbr.py); the dense math runs under jit."""

    def __init__(self, dec: "SBR.SbrDecoder", nch: int = 2):
        self.dec = dec
        self.static = SbrStatic(dec)
        M = self.static.M
        # nch > 2 batches several streams' channels into one dispatch
        # (the multi-stream serving shape, serving.py)
        self.state_host = [SBR.SbrChannelState() for _ in range(nch)]
        self.state_dev = [self._init_state() for _ in range(nch)]
        self.first = [True] * nch
        self._stacked = None          # (C, ...) device state for multi
        self._core_ov = None          # (C, 1024) device core overlap
        self._fn = _group_fn(self.static)

    def _init_state(self):
        M = self.static.M
        return device_init_state(M)

    def decode_group(self, ch: int, pcm_frames: np.ndarray,
                     datas: list, Es: list, Qs: list) -> np.ndarray:
        """pcm_frames (F, 1024) core PCM; datas/Es/Qs per frame.
        Returns (F*2048,) float32 at the doubled rate."""
        import jax.numpy as jnp
        cond = build_frame_cond(self.dec, self.state_host[ch],
                                self.static, datas, Es, Qs,
                                self.first[ch])
        self.first[ch] = False
        cd = {k: jnp.asarray(v) for k, v in vars(cond).items()}
        out, st = self._fn(jnp.asarray(pcm_frames, jnp.float32),
                           cd, self.state_dev[ch])
        self.state_dev[ch] = st
        return np.asarray(out)

    def decode_group_multi_lazy(self, pcm_frames: np.ndarray,
                                per_ch: list):
        """All channels in one device call, dispatched asynchronously.
        pcm_frames (C, F, 1024) core PCM; per_ch[c] = (datas, Es, Qs).
        Returns a zero-arg resolve function that blocks on the download
        and yields (C, F*2048) int32 in the pipeline's native range —
        jax dispatch is async, so the device executes while the host
        parses the next group."""
        import jax
        import jax.numpy as jnp
        nch, F = pcm_frames.shape[:2]
        # fill channel conds straight into (C, ...)-stacked arrays so
        # the device_put needs no np.stack copies of the big planes
        stacked = self._build_stacked_cond(nch, F, per_ch)
        cd = {k: jnp.asarray(v) for k, v in stacked.items()}
        st = self._stacked
        if st is None:
            st = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *self.state_dev[:nch])
        fn = _group_fn_multi(self.static)
        out, new_st = fn(jnp.asarray(pcm_frames, jnp.float32), cd, st)
        self._stacked = new_st        # stays stacked on device
        return lambda: np.asarray(out).astype(np.int32)  # int16 wire

    def decode_group_multi(self, pcm_frames: np.ndarray,
                           per_ch: list) -> np.ndarray:
        """Synchronous decode_group_multi_lazy."""
        return self.decode_group_multi_lazy(pcm_frames, per_ch)()

    def _build_stacked_cond(self, nch: int, F: int, per_ch: list):
        """Fill every channel's conditioning straight into (C, ...)
        stacked arrays (shared by the pcm- and spec-mode dispatchers)."""
        proto = vars(SbrFrameCond(F, self.static))
        # broadcast the prototype's DEFAULTS (env_id/prev_id are -1 =
        # unassigned; zero would mean "assigned to env 0")
        stacked = {k: np.broadcast_to(v, (nch,) + v.shape).copy()
                   for k, v in proto.items()}
        for ch in range(nch):
            view = SbrFrameCond.__new__(SbrFrameCond)
            for k in proto:
                setattr(view, k, stacked[k][ch])
            datas, Es, Qs = per_ch[ch]
            build_frame_cond(self.dec, self.state_host[ch], self.static,
                             datas, Es, Qs, self.first[ch], cond=view)
            self.first[ch] = False
        return stacked

    def decode_group_multi_lazy_spec(self, specs: np.ndarray,
                                     ops: np.ndarray, per_ch: list,
                                     host_overlap: np.ndarray):
        """decode_group_multi_lazy with the LC core fused on device:
        specs (C, F, 1024) f32 prepared spectra, ops (C, F) i32
        operator indices (same wire bytes as PCM — the host sheds the
        core IMDCT matmul).  ``host_overlap`` (C, 1024) seeds the
        device overlap on the first spec group or after a numpy-
        fallback group (fetch_core_overlap resyncs the host)."""
        import jax
        import jax.numpy as jnp
        nch, F = specs.shape[:2]
        stacked = self._build_stacked_cond(nch, F, per_ch)
        cd = {k: jnp.asarray(v) for k, v in stacked.items()}
        st = self._stacked
        if st is None:
            st = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *self.state_dev[:nch])
        ov = self._core_ov
        if ov is None:
            ov = jnp.asarray(np.asarray(host_overlap[:nch],
                                        np.float32))
        fn = _group_fn_multi_spec(self.static)
        out, new_st, new_ov = fn(jnp.asarray(specs, jnp.float32),
                                 jnp.asarray(ops, jnp.int32), cd, st,
                                 ov)
        self._stacked = new_st        # stays stacked on device
        self._core_ov = new_ov
        return lambda: np.asarray(out).astype(np.int32)  # int16 wire

    def decode_group_multi_lazy_zz(self, zz: dict, per_ch: list,
                                   host_overlap: np.ndarray):
        """Spec-mode dispatch with the LC core on the zigzag-nibble
        wire: ``zz`` holds this group's decode_chunk_zz inputs (q4
        (G, SC, 512) u8, sfb, ssf, ssr, msb, opx, epak, eva2, side,
        srow) plus 'consts' — the five pre-uploaded device constants
        (M_long, M_short, W, SW, E_sf).  The (SC, 1024) core overlap
        carries on device exactly like spec mode."""
        import jax
        import jax.numpy as jnp
        nch = len(per_ch)
        F = zz["q4"].shape[0]
        stacked = self._build_stacked_cond(nch, F, per_ch)
        cd = {k: jnp.asarray(v) for k, v in stacked.items()}
        st = self._stacked
        if st is None:
            st = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *self.state_dev[:nch])
        ov = self._core_ov
        if ov is None:
            ov = jnp.asarray(np.asarray(host_overlap[:nch],
                                        np.float32))
        fn = _group_fn_multi_zz(self.static)
        out, new_st, new_ov = fn(
            jnp.asarray(zz["q4"]), jnp.asarray(zz["sfb"]),
            jnp.asarray(zz["ssf"]), jnp.asarray(zz["ssr"]),
            jnp.asarray(zz["msb"]), jnp.asarray(zz["opx"]),
            jnp.asarray(zz["epak"]), jnp.asarray(zz["eva2"]),
            jnp.asarray(zz["side"]), jnp.asarray(zz["srow"]),
            *zz["consts"],
            jnp.asarray(zz["tfi"]), jnp.asarray(zz["tco"]),
            jnp.asarray(zz["tdir"]), jnp.asarray(zz["trow"]),
            cd, st, ov)
        self._stacked = new_st
        self._core_ov = new_ov
        return lambda: np.asarray(out).astype(np.int32)

    def fetch_core_overlap(self):
        """Download the device core-overlap tail (state after the last
        dispatched spec-mode group) and forget it — the caller installs
        it into the host _StreamState before a numpy-fallback group
        decodes, and the next spec group re-seeds from the host."""
        if self._core_ov is None:
            return None
        ov = np.asarray(self._core_ov)
        self._core_ov = None
        return ov


# ---------------------------------------------------------------------------
# Parametric stereo on device (HE-AAC v2): hybrid filterbank as batched
# FIR matmuls, the decorrelator as ONE lax.scan over the group's slots,
# mixing with host-precomputed per-slot rotation matrices.  Mirrors the
# numpy PsDecoder in sbr.py (float reformulation of fdk psdec.cpp),
# which stays the fallback and the conformance oracle.

class PsStatic:
    """Static decorrelator/mixer conditioning built from the PS ROM
    tables (sbr.py PsDecoder constants)."""

    def __init__(self):
        T = SBR.tables()
        b20 = list(SBR._PS_GROUP_BORDERS20)
        b2g = list(SBR._PS_BINS2GROUP20)
        self.phi_sub = (T["ps_aaFractDelayPhaseFactorReSubQmf20"]
                        + 1j * T["ps_aaFractDelayPhaseFactorImSubQmf20"])
        phi_qmf = (T["ps_aaFractDelayPhaseFactorReQmf"]
                   + 1j * T["ps_aaFractDelayPhaseFactorImQmf"])
        self.phi_qmf = phi_qmf[3:23]                       # sb 3..22
        self.phi_ser_sub = (
            T["ps_aaFractDelayPhaseFactorSerReSubQmf20"]
            + 1j * T["ps_aaFractDelayPhaseFactorSerImSubQmf20"]
        ).reshape(12, 3)
        self.phi_ser_qmf = (
            T["ps_aaFractDelayPhaseFactorSerReQmf"]
            + 1j * T["ps_aaFractDelayPhaseFactorSerImQmf"]
        ).reshape(64, 3)[3:23]
        self.decay_ser = T["ps_aAllpassLinkDecaySer"].astype(np.float32)
        self.decay_scale = T["ps_decayScaleFactTable"][3:23] \
            .astype(np.float32)
        dl = T["ps_delayIndexQmf"].astype(int)
        # per-band ring lengths for QMF sb 23..63 (the table is indexed
        # by absolute sb); read offset in the rolled 14-deep buffer
        self.long_read_off = (14 - dl[23:64]).astype(np.int32)
        # power mapping (20, 12) over |hyb|^2 and (20, 61) over |qmf|^2
        Psub = np.zeros((20, 12), np.float32)
        for tgt, srcs in enumerate([(0, 7), (1, 6), (2,), (3,), (9,),
                                    (8,), (10,), (11,)]):
            for s in srcs:
                Psub[tgt, s] = 1.0
        Pqmf = np.zeros((20, 61), np.float32)
        for bin_ in range(8, 20):
            lo, hi = b20[bin_ + 2], b20[bin_ + 3]
            Pqmf[bin_, lo - 3:hi - 3] = 1.0
        self.Psub, self.Pqmf = Psub, Pqmf
        # transient-bin / mixing-group per channel (73 = 12 hyb + 61)
        grp = np.zeros(73, np.int32)
        mask = np.zeros(73, np.float32)
        for gr in range(10):
            sb = b20[gr]
            grp[sb] = gr
            mask[sb] = 1.0
        for gr in range(10, 22):
            for sb in range(b20[gr], b20[gr + 1]):
                grp[12 + sb - 3] = gr
                mask[12 + sb - 3] = 1.0
        self.chan_group = grp
        self.chan_mask = mask
        self.trans_bin = np.asarray(b2g, np.int32)         # (22,)
        # hybrid analysis kernels (13-slot FIRs)
        n = np.arange(13)[:, None]
        q8 = np.arange(8)[None, :]
        self.H8 = (SBR._PS_G8[:, None]
                   * np.exp(1j * 2.0 * np.pi / 8.0 * (q8 + 0.5)
                            * (6 - n))).astype(np.complex64)
        q2 = np.arange(2)[None, :]
        self.H2 = (SBR._PS_G2[:, None]
                   * np.cos(np.pi * q2 * (6 - n))).astype(np.complex64)


def ps_init_state():
    z = np.zeros
    c = lambda *s: (z(s, np.float32), z(s, np.float32))
    st = {"pd": z(20, np.float32), "ppd": z(20, np.float32),
          "pnrg": z(20, np.float32)}
    for nm, shape in (("d2s", (2, 12)), ("d2q", (2, 20)),
                      ("s3s", (12, 3)), ("s4s", (12, 4)),
                      ("s5s", (12, 5)), ("s3q", (20, 3)),
                      ("s4q", (20, 4)), ("s5q", (20, 5)),
                      ("lng", (41, 14))):
        st[nm + "_re"], st[nm + "_im"] = c(*shape)
    st["hyb_hist_re"] = z((12, 3), np.float32)
    st["hyb_hist_im"] = z((12, 3), np.float32)
    st["dline_re"] = z((6, 61), np.float32)
    st["dline_im"] = z((6, 61), np.float32)
    return st


def ps_decorrelate_mix(static: PsStatic, ps: "PsStatic", Zr, Zi,
                       H_slots, state):
    """Device PS stage: Z (S, 64) complex mid QMF -> (Lr, Li, Rr, Ri)
    each (S, 64).  H_slots (S, 4, 22) f32 host-interpolated mixing
    matrices; state from ps_init_state (returned updated)."""
    import jax
    jnp = _jnp()
    S = Zr.shape[0]
    # ---- hybrid analysis (batched 13-tap FIRs over slots) -----------
    low_r = jnp.concatenate([state["hyb_hist_re"], Zr[:, :3]])
    low_i = jnp.concatenate([state["hyb_hist_im"], Zi[:, :3]])
    win_r = jnp.stack([low_r[s:s + S] for s in range(13)], axis=1)
    win_i = jnp.stack([low_i[s:s + S] for s in range(13)], axis=1)
    H8r, H8i = jnp.asarray(static.H8.real), jnp.asarray(static.H8.imag)
    H2r = jnp.asarray(static.H2.real)
    hyb_r = jnp.zeros((S, 12), jnp.float32)
    hyb_i = jnp.zeros((S, 12), jnp.float32)
    a_r, a_i = win_r[:, :, 0], win_i[:, :, 0]        # (S, 13)
    HI = jax.lax.Precision.HIGHEST
    dot = lambda a, b: jnp.dot(a, b, precision=HI)
    hyb_r = hyb_r.at[:, 0:8].set(dot(a_r, H8r) - dot(a_i, H8i))
    hyb_i = hyb_i.at[:, 0:8].set(dot(a_r, H8i) + dot(a_i, H8r))
    hyb_r = hyb_r.at[:, 8:10].set(dot(win_r[:, :, 1], H2r))
    hyb_i = hyb_i.at[:, 8:10].set(dot(win_i[:, :, 1], H2r))
    hyb_r = hyb_r.at[:, 10:12].set(dot(win_r[:, :, 2], H2r))
    hyb_i = hyb_i.at[:, 10:12].set(dot(win_i[:, :, 2], H2r))
    hyb_r = hyb_r.at[:, 3].add(hyb_r[:, 4])
    hyb_i = hyb_i.at[:, 3].add(hyb_i[:, 4])
    hyb_r = hyb_r.at[:, 2].add(hyb_r[:, 5])
    hyb_i = hyb_i.at[:, 2].add(hyb_i[:, 5])
    zero45 = jnp.asarray(
        np.array([1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1], np.float32))
    hyb_r = hyb_r * zero45
    hyb_i = hyb_i * zero45
    rest_r = jnp.concatenate([state["dline_re"], Zr[:, 3:]])
    rest_i = jnp.concatenate([state["dline_im"], Zi[:, 3:]])
    mid_r = jnp.concatenate([hyb_r, rest_r[:S]], axis=1)   # (S, 73)
    mid_i = jnp.concatenate([hyb_i, rest_i[:S]], axis=1)

    # ---- decorrelator + mixing scan over slots ----------------------
    phi_sub_r = jnp.asarray(static.phi_sub.real.astype(np.float32))
    phi_sub_i = jnp.asarray(static.phi_sub.imag.astype(np.float32))
    phi_qmf_r = jnp.asarray(static.phi_qmf.real.astype(np.float32))
    phi_qmf_i = jnp.asarray(static.phi_qmf.imag.astype(np.float32))
    pss_r = jnp.asarray(static.phi_ser_sub.real.astype(np.float32))
    pss_i = jnp.asarray(static.phi_ser_sub.imag.astype(np.float32))
    psq_r = jnp.asarray(static.phi_ser_qmf.real.astype(np.float32))
    psq_i = jnp.asarray(static.phi_ser_qmf.imag.astype(np.float32))
    dser = jnp.asarray(static.decay_ser)
    dsf = jnp.asarray(static.decay_scale)
    Psub = jnp.asarray(static.Psub)
    Pqmf = jnp.asarray(static.Pqmf)
    cgrp = jnp.asarray(static.chan_group)
    cmask = jnp.asarray(static.chan_mask)
    tbin = jnp.asarray(static.trans_bin)
    loff = jnp.asarray(static.long_read_off)
    PK = np.float32(SBR._PS_PEAK_DECAY)
    IC = np.float32(SBR._PS_INT_COEFF)
    TI = np.float32(SBR._PS_TRANS_IMPACT)

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    def step(carry, inp):
        (pd, ppd, pnrg, d2s_r, d2s_i, d2q_r, d2q_i,
         sers, lng_r, lng_i) = carry
        mr, mi, H = inp                     # (73,), (73,), (4, 22)
        hr, hi = mr[:12], mi[:12]
        qr, qi = mr[12:], mi[12:]
        p = jnp.dot(Psub, hr * hr + hi * hi,
                    precision=jax.lax.Precision.HIGHEST) \
            + jnp.dot(Pqmf, qr * qr + qi * qi,
                      precision=jax.lax.Precision.HIGHEST)
        pd = jnp.maximum(pd * PK, p)
        ppd = ppd + IC * (pd - p - ppd)
        pnrg = jnp.maximum(0.0, pnrg + IC * (p - pnrg))
        nrg = pnrg * TI
        trans = jnp.where(ppd <= nrg, 1.0,
                          nrg / jnp.maximum(ppd, 1e-30))
        # sub channels (12): 2-slot delay + fract phase + 3 allpasses
        r0r, r0i = cmul(d2s_r[0], d2s_i[0], phi_sub_r, phi_sub_i)
        d2s_r = jnp.stack([d2s_r[1], hr])
        d2s_i = jnp.stack([d2s_i[1], hi])
        new_sers = list(sers)
        for mi_ in range(3):
            sr_re, sr_im = sers[mi_]        # (12, d)
            tr_, ti_ = cmul(sr_re[:, 0], sr_im[:, 0],
                            pss_r[:, mi_], pss_i[:, mi_])
            tr_ = tr_ - dser[mi_] * r0r
            ti_ = ti_ - dser[mi_] * r0i
            wr = r0r + dser[mi_] * tr_
            wi = r0i + dser[mi_] * ti_
            new_sers[mi_] = (
                jnp.concatenate([sr_re[:, 1:], wr[:, None]], axis=1),
                jnp.concatenate([sr_im[:, 1:], wi[:, None]], axis=1))
            r0r, r0i = tr_, ti_
        dsub_r, dsub_i = r0r, r0i
        # qmf sb 3..22 (20): with decay ramp
        r0r, r0i = cmul(d2q_r[0], d2q_i[0], phi_qmf_r, phi_qmf_i)
        d2q_r = jnp.stack([d2q_r[1], qr[:20]])
        d2q_i = jnp.stack([d2q_i[1], qi[:20]])
        res_r, res_i = dsf * r0r, dsf * r0i
        for mi_ in range(3):
            sr_re, sr_im = sers[3 + mi_]    # (20, d)
            tr_, ti_ = cmul(sr_re[:, 0], sr_im[:, 0],
                            psq_r[:, mi_], psq_i[:, mi_])
            tr_ = tr_ - dser[mi_] * res_r
            ti_ = ti_ - dser[mi_] * res_i
            res_r, res_i = dsf * tr_, dsf * ti_
            wr = r0r + dser[mi_] * res_r
            wi = r0i + dser[mi_] * res_i
            new_sers[3 + mi_] = (
                jnp.concatenate([sr_re[:, 1:], wr[:, None]], axis=1),
                jnp.concatenate([sr_im[:, 1:], wi[:, None]], axis=1))
            r0r, r0i = tr_, ti_
        dq20_r, dq20_i = r0r, r0i
        # qmf sb 23..63 (41): plain ragged delays in a rolled buffer
        dlong_r = jnp.take_along_axis(lng_r, loff[:, None],
                                      axis=1)[:, 0]
        dlong_i = jnp.take_along_axis(lng_i, loff[:, None],
                                      axis=1)[:, 0]
        lng_r = jnp.concatenate([lng_r[:, 1:], qr[20:61][:, None]],
                                axis=1)
        lng_i = jnp.concatenate([lng_i[:, 1:], qi[20:61][:, None]],
                                axis=1)
        d_r = jnp.concatenate([dsub_r, dq20_r, dlong_r])
        d_i = jnp.concatenate([dsub_i, dq20_i, dlong_i])
        tch = trans[tbin[cgrp]]
        d_r = d_r * tch
        d_i = d_i * tch
        # mixing: per-channel group matrices
        h11 = H[0][cgrp]
        h12 = H[1][cgrp]
        h21 = H[2][cgrp]
        h22 = H[3][cgrp]
        Lr = (h11 * mr + h21 * d_r) * cmask
        Li = (h11 * mi + h21 * d_i) * cmask
        Rr = (h12 * mr + h22 * d_r) * cmask
        Ri = (h12 * mi + h22 * d_i) * cmask
        carry = (pd, ppd, pnrg, d2s_r, d2s_i, d2q_r, d2q_i,
                 tuple(new_sers), lng_r, lng_i)
        return carry, (Lr, Li, Rr, Ri)

    sers0 = tuple(
        (state[k + "_re"], state[k + "_im"])
        for k in ("s3s", "s4s", "s5s", "s3q", "s4q", "s5q"))
    carry0 = (state["pd"], state["ppd"], state["pnrg"],
              state["d2s_re"], state["d2s_im"],
              state["d2q_re"], state["d2q_im"], sers0,
              state["lng_re"], state["lng_im"])
    carry, (Lr, Li, Rr, Ri) = jax.lax.scan(
        step, carry0, (mid_r, mid_i, H_slots))

    def hyb_syn(cr, ci):
        Xr = jnp.concatenate(
            [cr[:, 0:8].sum(axis=1, keepdims=True),
             cr[:, 8:10].sum(axis=1, keepdims=True),
             cr[:, 10:12].sum(axis=1, keepdims=True), cr[:, 12:]],
            axis=1)
        Xi = jnp.concatenate(
            [ci[:, 0:8].sum(axis=1, keepdims=True),
             ci[:, 8:10].sum(axis=1, keepdims=True),
             ci[:, 10:12].sum(axis=1, keepdims=True), ci[:, 12:]],
            axis=1)
        return Xr, Xi

    XLr, XLi = hyb_syn(Lr, Li)
    XRr, XRi = hyb_syn(Rr, Ri)
    new_state = dict(state)
    new_state.update({
        "pd": carry[0], "ppd": carry[1], "pnrg": carry[2],
        "d2s_re": carry[3], "d2s_im": carry[4],
        "d2q_re": carry[5], "d2q_im": carry[6],
        "lng_re": carry[8], "lng_im": carry[9],
        "hyb_hist_re": low_r[S:S + 12], "hyb_hist_im": low_i[S:S + 12],
        "dline_re": rest_r[S:S + 6], "dline_im": rest_i[S:S + 6]})
    for k, (re, im) in zip(("s3s", "s4s", "s5s", "s3q", "s4q", "s5q"),
                           carry[7]):
        new_state[k + "_re"] = re
        new_state[k + "_im"] = im
    return XLr, XLi, XRr, XRi, new_state


def build_ps_H_slots(pdec, ps_datas: list, nsl: int = 32) -> np.ndarray:
    """Host mirror of PsDecoder.process()'s mixing-matrix evolution for
    a group: decodes IID/ICC with the carried delta state, interpolates
    the type-A rotation matrices per slot.  ``pdec`` is a numpy
    SBR.PsDecoder used ONLY for its parameter state (prev_iid/prev_icc,
    H carry, last_ps); its DSP is never run here."""
    F = len(ps_datas)
    H_slots = np.zeros((F * nsl, 4, 22), np.float32)
    for f, ps in enumerate(ps_datas):
        if ps is None:
            ps = SBR.PsData(header_valid=True,
                            enable_iid=pdec.last_ps.enable_iid,
                            mode_iid=pdec.last_ps.mode_iid,
                            enable_icc=pdec.last_ps.enable_icc,
                            mode_icc=pdec.last_ps.mode_icc,
                            frame_class=0, n_env=0)
        pdec.last_ps = ps
        iid_rows, icc_rows, pdec.prev_iid, pdec.prev_icc = \
            SBR.decode_ps_indices(ps, pdec.prev_iid, pdec.prev_icc)
        fine = ps.mode_iid > 2
        if (ps.mode_iid % 3) == 2:
            iid_rows = [SBR._ps_map34_to_20(SBR._pad34(r))
                        for r in iid_rows]
        if (ps.mode_icc % 3) == 2:
            icc_rows = [SBR._ps_map34_to_20(SBR._pad34(r))
                        for r in icc_rows]
        n_env = len(iid_rows)
        borders = SBR.PsDecoder._env_borders(ps, n_env, nsl)
        for env in range(n_env):
            t0, t1 = borders[env], borders[env + 1]
            if t1 <= t0:
                continue
            h_tgt = pdec._group_matrices(iid_rows[env], icc_rows[env],
                                         fine)
            dH = (h_tgt - pdec.H) / (t1 - t0)
            H = pdec.H
            for sl in range(t0, t1):
                H = H + dH
                H_slots[f * nsl + sl] = H
            pdec.H = h_tgt
    # apply the hybrid path's 6-slot group delay to the H timeline
    # (PsDecoder._h_delay rationale: the signal is delayed, fdk's is
    # not, so H must ride the same delay to land on the right slots)
    q = getattr(pdec, "_h_delay", None)
    if q is not None and len(q) >= 6:
        carry = np.stack([q[i] for i in range(6)]).astype(np.float32)
        for i in range(6):
            q[i] = H_slots[F * nsl - 6 + i].astype(np.float64)
    else:
        carry = np.repeat(H_slots[:1], 6, axis=0)
    delayed = np.concatenate([carry, H_slots[:-6]], axis=0)
    return delayed


def device_decode_group_ps(static: SbrStatic, ps_static: PsStatic,
                           pcm, cond: dict, state: dict,
                           ps_state: dict, syn_state_r, H_slots):
    """HE-AAC v2 group decode: SBR reconstruction of the mono core,
    device parametric stereo, two synthesis QMFs.  Returns
    (out (2, F*2048), new_state, new_ps_state, new_syn_r)."""
    jnp = _jnp()
    (Zr, Zi), new_state = device_decode_group(static, pcm, cond, state,
                                              ps_extras=True)
    XLr, XLi, XRr, XRi, new_ps = ps_decorrelate_mix(
        ps_static, ps_static, Zr, Zi, H_slots, ps_state)
    outL, synL = synthesize_slots(static, XLr, XLi, state["syn_state"])
    outR, synR = synthesize_slots(static, XRr, XRi, syn_state_r)
    new_state = dict(new_state)
    new_state["syn_state"] = synL
    return jnp.stack([outL, outR]), new_state, new_ps, synR


class SbrPsDeviceRunner:
    """Device HE-AAC v2 path: mono core SBR + parametric stereo for
    whole frame groups under one jit."""

    def __init__(self, dec: "SBR.SbrDecoder"):
        self.dec = dec
        self.static = SbrStatic(dec)
        self.ps_static = PsStatic()
        M = self.static.M
        self.state_host = SBR.SbrChannelState()
        self.state_dev = device_init_state(M)
        self.ps_state = ps_init_state()
        self.syn_state_r = np.zeros(704, np.float32)
        self.pdec_host = SBR.PsDecoder()
        self.first = True
        self._core_ov = None          # (1024,) device core overlap
        self._fn = _group_fn_ps(self.static, self.ps_static)

    def decode_group_lazy(self, pcm_frames: np.ndarray, datas: list,
                          Es: list, Qs: list, ps_list: list):
        """Async dispatch; returns a zero-arg resolve function (see
        SbrDeviceRunner.decode_group_multi_lazy)."""
        import jax.numpy as jnp
        cond = build_frame_cond(self.dec, self.state_host, self.static,
                                datas, Es, Qs, self.first)
        self.first = False
        H = build_ps_H_slots(self.pdec_host, ps_list, 32)
        cd = {k: jnp.asarray(v) for k, v in vars(cond).items()}
        out, st, pst, synr = self._fn(
            jnp.asarray(pcm_frames, jnp.float32), cd, self.state_dev,
            self.ps_state, jnp.asarray(self.syn_state_r),
            jnp.asarray(H))
        self.state_dev = st
        self.ps_state = pst
        self.syn_state_r = synr
        return lambda: np.asarray(out)

    def decode_group(self, pcm_frames: np.ndarray, datas: list,
                     Es: list, Qs: list, ps_list: list) -> np.ndarray:
        return self.decode_group_lazy(pcm_frames, datas, Es, Qs,
                                      ps_list)()

    def decode_group_lazy_spec(self, specs: np.ndarray,
                               ops: np.ndarray, datas: list, Es: list,
                               Qs: list, ps_list: list,
                               host_overlap: np.ndarray):
        """decode_group_lazy with the mono LC core fused on device:
        specs (F, 1024) f32 prepared spectra, ops (F,) i32 operator
        indices; host_overlap (1024,) seeds the device overlap (see
        SbrDeviceRunner.decode_group_multi_lazy_spec)."""
        import jax.numpy as jnp
        F = specs.shape[0]
        cond = build_frame_cond(self.dec, self.state_host, self.static,
                                datas, Es, Qs, self.first)
        self.first = False
        H = build_ps_H_slots(self.pdec_host, ps_list, 32)
        cd = {k: jnp.asarray(v) for k, v in vars(cond).items()}
        ov = self._core_ov
        if ov is None:
            ov = jnp.asarray(np.asarray(host_overlap, np.float32))
        fn = _group_fn_ps_spec(self.static, self.ps_static)
        out, st, pst, synr, new_ov = fn(
            jnp.asarray(specs, jnp.float32),
            jnp.asarray(ops, jnp.int32), cd, self.state_dev,
            self.ps_state, jnp.asarray(self.syn_state_r),
            jnp.asarray(H), ov)
        self.state_dev = st
        self.ps_state = pst
        self.syn_state_r = synr
        self._core_ov = new_ov
        return lambda: np.asarray(out)

    def fetch_core_overlap(self):
        """See SbrDeviceRunner.fetch_core_overlap (mono: (1024,))."""
        if self._core_ov is None:
            return None
        ov = np.asarray(self._core_ov)
        self._core_ov = None
        return ov
