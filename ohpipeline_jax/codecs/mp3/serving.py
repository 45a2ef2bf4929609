"""Multi-stream batched device MP3 decode — the serving shape (sibling
of codecs/flac/serving.py, codecs/aac/serving.py, opus/celt_jax and
vorbis/vorbis_jax's *_streams_device functions).

MP3 streams sharing MPEG version, sample rate and channel count decode
in groups: each stream's frames parse on the host (native Layer III
Huffman hot loop), requantize/stereo/alias vectorize per granule
(synthesis.prepare_granules), and every stream's channels stack into the
batch axis of ONE jitted scan-free filterbank program per group
(synthesis.hybrid_synthesis_parallel_i16) — the hybrid filterbank has no
cross-channel coupling, so stream channels ride the same dispatch and
the per-dispatch overhead amortizes across the batch.  Spectra
ship as int16 with per-granule-channel scales (half the wire bytes of
f32; ~3e-5 granule-relative error, the Vorbis int16-wire rationale).
Overlap and V-FIFO state stay device-resident between groups; downloads
pipeline behind the next group's parse.

Reference displaced: the per-stream mad_frame_decode + mad_synth_frame
loop (/root/reference/thirdparty/libmad-0.15.1b/frame.c, synth.c),
re-shaped for batched serving.

Conformance: tests/test_mp3_serving.py bounds the batch against the
host decode_mp3 path (itself sample-exact vs the libmad oracle).
"""

from __future__ import annotations

import numpy as np

from . import bitstream as BS
from . import synthesis as SYN
from . import parse_vbr_header, prepare_granules


def decode_mp3_streams_device(streams: list, frames_per_group: int = 32,
                              mesh=None):
    """streams: MP3 files (bytes) sharing MPEG version, sample rate and
    channel count (one compiled program serves the batch; mismatches
    raise).  Returns [(channels, nsamples) int32 PCM] per stream.
    Hostile/irregular streams should use CodecMp3 — this is the
    throughput API; a stream whose frames stop parsing early simply
    ends early (same stance as the other serving APIs).

    With ``mesh`` the (Tg, S*C, ...) spectra planes shard their stream
    axis over dp (parallel.serving_put); results match mesh=None."""
    import jax.numpy as jnp

    from ...parallel import serving_put
    from .. import _serving_util as _SU

    hdrs = [BS.parse_frame_header(s) for s in streams]
    if any(h is None for h in hdrs):
        raise ValueError("not an MP3 stream")
    h0 = hdrs[0]
    for h in hdrs[1:]:
        if (h.version, h.sample_rate, h.channels) \
                != (h0.version, h0.sample_rate, h0.channels):
            raise ValueError(
                "device batch needs uniform version/rate/channels")
    S = len(streams)
    nch = h0.channels
    G = frames_per_group
    SC = S * nch
    gpf = h0.granule_count                 # granules per frame (2 or 1)
    Tg = G * gpf
    if Tg & (Tg - 1):
        raise ValueError("frames_per_group * granules must be a power "
                         "of two (one compiled shape per batch)")

    ops = jnp.asarray(SYN._imdct_operators().astype(np.float32))
    poly = jnp.asarray(SYN._polyphase_matrix(), dtype=jnp.float32)
    wnd = jnp.asarray(SYN._window_matrix(), dtype=jnp.float32)

    parsers = []
    for s, data in enumerate(streams):
        st = BS.Mp3Stream(data)
        # the Xing/VBRI frame carries no audio (CodecMp3 skips it too)
        if parse_vbr_header(data, hdrs[s]):
            st.pos = hdrs[s].frame_bytes
        parsers.append(st)

    ov = jnp.zeros((SC, 576), jnp.float32)
    vf = jnp.zeros((SC, 16, 64), jnp.float32)
    live = [True] * S
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]

    def sink(pcm, counts_g):                   # (Tg, SC, 576) int32
        for s, tg in counts_g:
            if tg:
                cols = pcm[:tg, s * nch:(s + 1) * nch]
                outs[s].append(cols.transpose(1, 0, 2).reshape(nch, -1))

    drainer = _SU.ThreadedDrainer(sink)

    while any(live):
        q16 = np.zeros((Tg, SC, 576), np.int16)
        scl = np.zeros((Tg, SC), np.float32)
        btp = np.zeros((Tg, SC, 32), np.uint8)
        counts_g = []
        n_real = 0
        for s in range(S):
            if not live[s]:
                continue
            frames = []
            while len(frames) < G:
                fr = parsers[s].next_frame()
                if fr is None:
                    break
                frames.append(fr)
            if len(frames) < G:
                live[s] = False
            xr, bt = prepare_granules(frames, nch)
            tg = xr.shape[0]
            counts_g.append((s, tg))
            if not tg:
                continue
            n_real = max(n_real, tg)
            c0 = s * nch
            peak = np.abs(xr).max(axis=-1)             # (tg, nch)
            sc = np.where(peak > 0, peak, 1.0) * np.float32(1 / 32767.0)
            q16[:tg, c0:c0 + nch] = np.rint(
                xr / sc[..., None]).astype(np.int16)
            scl[:tg, c0:c0 + nch] = sc
            btp[:tg, c0:c0 + nch] = bt.astype(np.uint8)
        if not n_real:
            break
        # padded granules advance only dead streams' state (live streams
        # always fill the whole bucket), so the scalar n_real boundary is
        # safe — same stance as the AAC serving path's ragged tails
        if mesh is not None:
            q16, scl, btp = (serving_put(mesh, a, 1)
                             for a in (q16, scl, btp))
            ov = serving_put(mesh, ov, 0)
            vf = serving_put(mesh, vf, 0)
        pcm_i, ov, vf = SYN.hybrid_synthesis_parallel_i16(
            q16, scl, btp, ov, vf, ops, poly, wnd, n_real)
        drainer.put(lambda p=pcm_i: np.asarray(p), counts_g)
    drainer.close()
    return [np.concatenate(o, axis=1) if o else
            np.zeros((nch, 0), np.int32) for o in outs]
