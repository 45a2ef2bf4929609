"""Batched device CELT synthesis for CELT-only Opus streams.

The entropy layer stays on the host (native/celt_core.cc via
celt.decode_frame(synthesis=False)); everything downstream of the
entropy-decoded coefficients — denormalisation, the per-block IMDCT +
TDAC fold, the pitch post-filter comb and the deemphasis IIR — runs as
ONE jitted lax.scan over a group of frames, vmappable over streams:

* denormalise: per-band gains expand to per-bin gains with one (nb, N)
  matmul; freq = X * gains_bins.
* IMDCT + TDAC: the whole frame map freq -> overlap-buffer is LINEAR,
  so it is materialised as two matrices (long and transient 8-short
  block layouts) plus carry-in maps by probing the conformance-tested
  host code in celt.py with basis batches — construction is therefore
  layout-exact by definition.  Per frame: two matmuls + a one-hot
  select on the transient flag.
* comb post-filter: a feedback comb (reads already-filtered samples at
  lag T >= COMBFILTER_MINPERIOD = 15), evaluated as a lax.scan over
  12-sample blocks — every tap (T -/+ 2) of a block lands strictly
  before the block, so blocks are internally parallel.
* deemphasis: y[n] = x[n] + c*y[n-1] is linear in (x, carry), one
  (N, N) Toeplitz matmul + a carry power vector.

Single-stream realtime decode keeps the host path (one stream's frame
is too little work for a device dispatch); the device path is the multi-stream
serving shape, like the headline FLAC/AAC bench.  Reference displaced:
thirdparty/opus-1.5.2/celt/celt_decoder.c celt_synthesis +
comb_filter/deemphasis over OpenHome/Media/Codec/Opus.cpp.
"""

from __future__ import annotations

import numpy as np

from .celt import (COMB_GAINS, COMBFILTER_MINPERIOD, MAX_PERIOD,
                   CeltDecoderState, _imdct, celt_mode, decode_frame)

N_FRAME = 960                    # 20 ms @ 48 kHz (LM = 3)
HLEN = MAX_PERIOD + 2            # comb lookback: lag T <= 1024, taps +/-2
BLK = 12                         # comb scan block (< MINPERIOD - 2)


def _tdac_batch(freqs: np.ndarray, carries: np.ndarray,
                transient: bool) -> np.ndarray:
    """Batched copy of the host per-block IMDCT + TDAC fold
    (celt.decode_frame synthesis loop) used to probe the linear maps —
    and as the layout oracle in tests.  freqs (K, N), carries
    (K, ov//2) -> buf (K, N + ov)."""
    mode = celt_mode()
    N = N_FRAME
    ov = mode.overlap
    B = 8 if transient else 1
    NB = N // B
    win = mode.window
    K = freqs.shape[0]
    buf = np.zeros((K, N + ov))
    buf[:, :ov // 2] = carries
    ii = np.arange(ov // 2)
    for b in range(B):
        raw = _imdct(freqs[:, b::B] if B > 1 else freqs, NB)
        base = b * NB
        prev = buf[:, base:base + ov // 2].copy()
        buf[:, base + ov // 2:base + ov // 2 + NB] = raw
        x1 = raw[:, ov // 2 - 1 - ii]
        buf[:, base + ii] = win[ov - 1 - ii] * prev - win[ii] * x1
        buf[:, base + ov - 1 - ii] = (win[ii] * prev
                                      + win[ov - 1 - ii] * x1)
    return buf


class CeltDeviceStatic:
    """Per-process constants for the device group program (f32)."""

    def __init__(self):
        import jax.numpy as jnp
        mode = celt_mode()
        N = N_FRAME
        ov = mode.overlap
        self.ov = ov
        self.nb = mode.nb_ebands
        self.coef0 = float(mode.preemph[0])
        # frame synthesis maps by basis probing (freq and carry bases)
        eyeN = np.eye(N)
        z60 = np.zeros((N, ov // 2))
        eyeC = np.eye(ov // 2)
        zN = np.zeros((ov // 2, N))
        S = np.stack([_tdac_batch(eyeN, z60, False),
                      _tdac_batch(eyeN, z60, True)])
        Cm = np.stack([_tdac_batch(zN, eyeC, False),
                       _tdac_batch(zN, eyeC, True)])
        self.S = jnp.asarray(S, jnp.float32)          # (2, N, N+ov)
        self.Cm = jnp.asarray(Cm, jnp.float32)        # (2, ov/2, N+ov)
        # band -> bin expansion (M = 8 bins per band unit at LM=3)
        M = 8
        be = np.zeros((self.nb, N), np.float32)
        for i in range(self.nb):
            be[i, M * int(mode.ebands[i]):M * int(mode.ebands[i + 1])] = 1
        self.band_expand = jnp.asarray(be)
        # deemphasis as a Toeplitz matmul + carry powers
        i_ = np.arange(N)
        D = np.where(i_[:, None] >= i_[None, :],
                     self.coef0 ** np.maximum(
                         i_[:, None] - i_[None, :], 0), 0.0)
        self.deemph = jnp.asarray(D.T, jnp.float32)   # (in, out) for x @ D
        self.dpow = jnp.asarray(self.coef0 ** (i_ + 1) / self.coef0,
                                jnp.float32)          # c^i: carry m at n=0
        self.win2 = jnp.asarray(mode.window[:ov] ** 2, jnp.float32)


def _comb_device(static, y, Tv, gt):
    """In-place feedback comb over y[:, HLEN:] (celt.c comb_filter
    semantics: segment 1 = first 120 samples crossfading param set
    0 -> 1, segment 2 = rest with set 1 -> 2 crossfaded over its first
    120 samples).  y (CH, HLEN + N); Tv (3,) i32 lags; gt (3, 3) f32
    tap-gain triples (gain x COMB_GAINS[tapset])."""
    import jax
    import jax.numpy as jnp
    N = N_FRAME
    ov = static.ov
    i_ = jnp.arange(N)
    seg = (i_ >= ov).astype(jnp.int32)                # 0 | 1
    T0s = jnp.where(seg == 0, Tv[0], Tv[1])
    T1s = jnp.where(seg == 0, Tv[1], Tv[2])
    g0v = jnp.where((seg == 0)[:, None], gt[0], gt[1])    # (N, 3)
    g1v = jnp.where((seg == 0)[:, None], gt[1], gt[2])
    within = i_ - seg * ov
    f = jnp.where(within < ov,
                  static.win2[jnp.clip(within, 0, ov - 1)], 1.0)

    def blk(yc, b):
        pos = HLEN + b * BLK
        loc = b * BLK
        idx = pos + jnp.arange(BLK)
        T0b = jax.lax.dynamic_slice(T0s, (loc,), (BLK,))
        T1b = jax.lax.dynamic_slice(T1s, (loc,), (BLK,))
        g0b = jax.lax.dynamic_slice(g0v, (loc, 0), (BLK, 3))
        g1b = jax.lax.dynamic_slice(g1v, (loc, 0), (BLK, 3))
        fb = jax.lax.dynamic_slice(f, (loc,), (BLK,))

        def taps(Tb, gb):
            base = idx - Tb
            t0 = jnp.take(yc, base, axis=1)
            tp1 = jnp.take(yc, base + 1, axis=1)
            tm1 = jnp.take(yc, base - 1, axis=1)
            tp2 = jnp.take(yc, base + 2, axis=1)
            tm2 = jnp.take(yc, base - 2, axis=1)
            return (gb[:, 0] * t0 + gb[:, 1] * (tp1 + tm1)
                    + gb[:, 2] * (tp2 + tm2))

        cur = jax.lax.dynamic_slice(
            yc, (0, pos), (yc.shape[0], BLK))
        outb = cur + (1.0 - fb) * taps(T0b, g0b) + fb * taps(T1b, g1b)
        yc = jax.lax.dynamic_update_slice(yc, outb, (0, pos))
        return yc, None

    y, _ = jax.lax.scan(blk, y, jnp.arange(N // BLK))
    return y


#: int16 wire scale for the normalised coefficients: bands are
#: unit-norm so |X| <= 1 in practice (<= 2 with margin for stereo
#: recombination); quantisation sits ~84 dB below signal, well inside
#: the device-vs-host conformance bound.
X_SCALE = 16384.0


def _frame_step(static, carry, xs):
    """One CELT frame on device: denorm -> IMDCT/TDAC (matmul) ->
    comb -> deemph.  carry = (hist (CH, HLEN), c60 (CH, ov/2),
    m (CH,)); xs = (Xq int16 (CH, N) at X_SCALE, gains (CH, nb),
    op (2,), Tv (3,), gt (3, 3))."""
    import jax
    import jax.numpy as jnp
    hist, c60, m = carry
    Xq, gains, op, Tv, gt = xs
    X = Xq.astype(jnp.float32) * (1.0 / X_SCALE)
    P = jax.lax.Precision.HIGHEST
    freq = X * jnp.matmul(gains, static.band_expand, precision=P)
    Ssel = jnp.einsum("o,onk->nk", op, static.S, precision=P)
    Csel = jnp.einsum("o,oik->ik", op, static.Cm, precision=P)
    buf = (jnp.matmul(freq, Ssel, precision=P)
           + jnp.matmul(c60, Csel, precision=P))
    out = buf[:, :N_FRAME]
    c60n = buf[:, N_FRAME:N_FRAME + static.ov // 2]
    y = jnp.concatenate([hist, out], axis=1)
    y = _comb_device(static, y, Tv, gt)
    out2 = y[:, HLEN:]
    histn = y[:, -HLEN:]
    pcm = (jnp.matmul(out2, static.deemph, precision=P)
           + m[:, None] * static.dpow[None, :])
    mn = static.coef0 * pcm[:, -1]
    return (histn, c60n, mn), pcm


def device_decode_group(static, X, gains, op, Tv, gt, state):
    """(F, CH, N) group -> (F, CH, N) int16 PCM + new state (jit
    this; scan over frames carries the synthesis state)."""
    import jax
    import jax.numpy as jnp

    def step(c, xs):
        return _frame_step(static, c, xs)

    state2, pcm = jax.lax.scan(step, state, (X, gains, op, Tv, gt))
    pcm16 = jnp.clip(jnp.round(pcm), -32768, 32767).astype(jnp.int16)
    return pcm16, state2


_STATIC = None
_GROUP_JIT = {}


def _static() -> CeltDeviceStatic:
    global _STATIC
    if _STATIC is None:
        _STATIC = CeltDeviceStatic()
    return _STATIC


def _group_fn(batched: bool):
    """jitted group program, optionally vmapped over a stream axis."""
    import jax
    key = batched
    if key not in _GROUP_JIT:
        st = _static()

        def fn(X, gains, op, Tv, gt, h, c, m):
            return device_decode_group(st, X, gains, op, Tv, gt,
                                       (h, c, m))

        f = jax.vmap(fn) if batched else fn
        _GROUP_JIT[key] = jax.jit(f)
    return _GROUP_JIT[key]


def _open_capture(data: bytes):
    """(channels, frame-capture generator) for one CELT-only stream —
    incremental so multi-stream decode can interleave host entropy
    with device transfers."""
    from ..base import BufferReader
    from ..opus_headers import parse_opus_head, parse_opus_tags
    from ...containers.ogg import OggReader
    from . import split_packet_frames

    packets = list(OggReader(BufferReader(data)).packets())
    parse_opus_head(packets[0])
    parse_opus_tags(packets[1])
    toc0, _ = split_packet_frames(packets[2])
    if toc0.mode != "celt" or toc0.frame_ms != 20:
        raise ValueError("device path: CELT-only 20 ms streams")
    sc = 2 if toc0.stereo else 1
    st = CeltDecoderState(sc)

    def gen():
        for pk in packets[2:]:
            toc, frames = split_packet_frames(pk)
            if toc.mode != "celt" or toc.frame_ms != 20:
                raise ValueError("device path: CELT-only 20 ms streams")
            if (2 if toc.stereo else 1) != sc:
                raise ValueError("device path: mono/stereo switch")
            for f in frames:
                yield decode_frame(st, f, N_FRAME, synthesis=False)

    return sc, gen()


def capture_stream(data: bytes):
    """Host side: Ogg Opus -> (channels, per-frame entropy captures)
    for the device path.  Only CELT-only 20 ms streams are supported
    (anything else raises — callers fall back to the host decoder)."""
    sc, gen = _open_capture(data)
    return sc, list(gen)


def _pack_captures(caps, channels: int):
    F = len(caps)
    X = np.zeros((F, channels, N_FRAME), np.int16)
    gains = np.zeros((F, channels, 21), np.float32)
    op = np.zeros((F, 2), np.float32)
    Tv = np.zeros((F, 3), np.int32)
    gt = np.zeros((F, 3, 3), np.float32)
    for i, cp in enumerate(caps):
        X[i] = np.clip(np.rint(cp["X"] * X_SCALE), -32768, 32767)
        gains[i] = cp["gains"]
        op[i, 1 if cp["is_transient"] else 0] = 1.0
        for k, (T, g, tap) in enumerate(cp["pf"]):
            Tv[i, k] = T
            gt[i, k] = g * np.asarray(COMB_GAINS[tap])
    return X, gains, op, Tv, gt


def decode_celt_stream_device(data: bytes, group: int = 32) -> np.ndarray:
    """Whole-stream device decode of one CELT-only Ogg Opus stream ->
    (channels, n) int16 PCM at 48 kHz (no pre-skip/gain trimming —
    this is the synthesis-path conformance/throughput surface; the
    product path is CodecOpus)."""
    ch, caps = capture_stream(data)
    fn = _group_fn(False)
    st = _static()
    h = np.zeros((ch, HLEN), np.float32)
    c = np.zeros((ch, st.ov // 2), np.float32)
    m = np.zeros((ch,), np.float32)
    outs = []
    for g0 in range(0, len(caps), group):
        X, gains, op, Tv, gt = _pack_captures(caps[g0:g0 + group], ch)
        pcm16, (h, c, m) = fn(X, gains, op, Tv, gt, h, c, m)
        outs.append(np.asarray(pcm16))
    pcm = np.concatenate(outs, axis=0)          # (F, CH, N)
    return pcm.transpose(1, 0, 2).reshape(ch, -1)


def _slab_layout(S: int, G: int, ch: int):
    """One contiguous uint8 buffer per group: a single device_put per
    group (the same discipline as bench.py's Slab)."""
    fields = [("X", (S, G, ch, N_FRAME), np.int16),
              ("gains", (S, G, ch, 21), np.float32),
              ("op", (S, G, 2), np.float32),
              ("Tv", (S, G, 3), np.int32),
              ("gt", (S, G, 3, 3), np.float32)]
    lay = {}
    off = 0
    for nm, shape, dt in fields:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        lay[nm] = (off, shape, np.dtype(dt))
        off += (n + 63) & ~63
    return lay, off


def _slab_fn(S: int, G: int, ch: int):
    import jax
    import jax.numpy as jnp
    key = ("slab", S, G, ch)
    if key not in _GROUP_JIT:
        st = _static()
        lay, _total = _slab_layout(S, G, ch)

        def fn(buf, h, c, m):
            parts = {}
            for nm, (off, shape, dt) in lay.items():
                n = int(np.prod(shape)) * dt.itemsize
                raw = jax.lax.slice(buf, (off,), (off + n,))
                if dt.itemsize == 1:
                    arr = jax.lax.bitcast_convert_type(raw, jnp.dtype(dt))
                else:
                    arr = jax.lax.bitcast_convert_type(
                        raw.reshape(-1, dt.itemsize), jnp.dtype(dt))
                parts[nm] = arr.reshape(shape)

            def one(X, ga, op, Tv, gt, h1, c1, m1):
                return device_decode_group(st, X, ga, op, Tv, gt,
                                           (h1, c1, m1))

            return jax.vmap(one)(parts["X"], parts["gains"],
                                 parts["op"], parts["Tv"], parts["gt"],
                                 h, c, m)

        _GROUP_JIT[key] = jax.jit(fn)
    return _GROUP_JIT[key]


def decode_celt_streams_device(streams: list, group: int = 32):
    """Multi-stream serving shape: S independent CELT streams, entropy
    on host, synthesis batched on device (vmap over streams x scan
    over frames).  One slab upload + one exec per group; the partial
    tail group is zero-padded (silence frames) so every group hits ONE
    compiled program, and PCM downloads are deferred until all groups
    are dispatched so uploads/execs pipeline.  All streams must share
    the channel count; output is trimmed to the shortest stream.
    Returns (S, CH, n) int16."""
    import itertools
    import queue
    import threading

    import jax.numpy as jnp
    gens = []
    ch0 = None
    for i, s in enumerate(streams):
        ch, gen = _open_capture(s)
        ch0 = ch0 or ch
        if ch != ch0:
            raise ValueError(
                f"stream {i}: {ch} channels, batch is {ch0}-channel")
        gens.append(gen)
    S = len(gens)
    st = _static()
    lay, total = _slab_layout(S, group, ch0)
    fn = _slab_fn(S, group, ch0)
    h = jnp.zeros((S, ch0, HLEN), jnp.float32)
    c = jnp.zeros((S, ch0, st.ov // 2), jnp.float32)
    m = jnp.zeros((S, ch0), jnp.float32)
    # downloader thread drains finished groups while the main thread
    # captures/uploads the next ones (entropy decode releases the GIL
    # in the native core, transfers wait on the copy — they overlap)
    q: queue.Queue = queue.Queue()
    results: list = []

    def drain():
        while True:
            item = q.get()
            if item is None:
                return
            results.append(np.asarray(item))

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    F = 0
    try:
        while True:
            chunks = [list(itertools.islice(g, group)) for g in gens]
            n = min(len(cchunk) for cchunk in chunks)
            if n == 0:
                break
            F += n
            buf = np.zeros(total, np.uint8)
            views = {}
            for nm, (off, shape, dt) in lay.items():
                nbytes = int(np.prod(shape)) * dt.itemsize
                views[nm] = buf[off:off + nbytes].view(dt).reshape(shape)
            for si, cchunk in enumerate(chunks):
                X, gains, op, Tv, gt = _pack_captures(cchunk[:n], ch0)
                views["X"][si, :n] = X
                views["gains"][si, :n] = gains
                views["op"][si, :n] = op
                views["Tv"][si, :n] = Tv
                views["gt"][si, :n] = gt
            pcm16, (h, c, m) = fn(jnp.asarray(buf), h, c, m)
            q.put(pcm16)
            if n < group:
                break
    finally:
        q.put(None)
        th.join()
    pcm = np.concatenate(results, axis=1)[:, :F]        # (S, F, CH, N)
    return pcm.transpose(0, 2, 1, 3).reshape(S, ch0, -1)
