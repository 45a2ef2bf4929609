"""Multi-stream batched device FLAC decode over the rice wire — the
headline serving shape (bench.py's FLAC half) as a framework API, the
same stance as opus/celt_jax.decode_celt_streams_device and
vorbis/vorbis_jax.decode_vorbis_streams_device.

Per group, every stream's next `frames_per_group` frames parse through
native.flac_parse_group_rice — the entropy-coded stream bytes ship
as-is with per-unit bit cursors rebased into one shared bits buffer —
and ONE jitted device program (codecs.flac.synthesise_group_rice_jit)
rice-decodes and synthesises PCM for all streams' rows at once.  A
cheap survey parse sizes the shared planes so every group reuses one
compiled program.

Output is bit-exact vs the host decode_flac (tests/test_flac_serving.py).
Reference displaced: libFLAC's bitreader.c/stream_decoder.c decode loop
behind OpenHome/Media/Codec/Flac.cpp, re-shaped for batched serving.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import _serving_util as _SU
from . import frames as FF


def decode_flac_streams_device(streams: list, frames_per_group: int = 32,
                               mesh=None):
    """streams: FLAC files (bytes) sharing a channel count (bit depths
    and lengths may differ; max_blocksize must be a 64-multiple).
    Returns [(channels, nsamples) int32 PCM] per stream.

    With ``mesh`` (a jax.sharding.Mesh with a ``dp`` axis) the
    per-(frame,channel) row planes shard over dp — streams spread
    across devices, the shared rice wire replicates (see
    parallel.serving_put); results are identical to mesh=None."""
    from ... import native
    from ...parallel import serving_put
    from . import synthesise_group_rice_jit

    metas = [FF.parse_metadata(b) for b in streams]
    nch = metas[0].streaminfo.channels
    for m in metas[1:]:
        if m.streaminfo.channels != nch:
            raise ValueError("device batch needs a uniform channel count")
    stride = max(m.streaminfo.max_blocksize for m in metas)
    stride = -(-stride // 64) * 64
    S = len(streams)
    Gc = frames_per_group
    Bf = S * Gc * nch
    SLOTS = stride // 64
    scr = np.zeros((Gc * nch, stride), np.int32)

    # --- survey: per-group plane requirements (overflow/constfill/
    # escape counts, wire byte spans) so one compiled program serves
    # every group ------------------------------------------------------
    def survey():
        ocap = ccap = ecap = bcap = 0
        ngroups = 0
        pos = [m.header_bytes * 8 for m in metas]
        gc_t = np.zeros((Gc * nch, SLOTS), np.int32)
        gk_t = np.zeros((Gc * nch, SLOTS), np.int8)
        wm_t = np.zeros((Gc * nch, 32), np.int32)
        live = [True] * S
        g = 0
        while any(live):
            ob = cb = eb = bb = 0
            for s in range(S):
                if not live[s]:
                    continue
                ov = native.RiceOverflow(2 * Gc * nch * SLOTS + 64)
                cf = native.RiceConstFill(Gc * nch + 64)
                es = native.EscapeList(Gc * nch * stride + 64)
                n, pos[s], st, _b, (b0, b1) = native.flac_parse_group_rice(
                    streams[s], pos[s], gc_t, gk_t, wm_t, scr, ov, cf,
                    es, 0, sample_rate=metas[s].streaminfo.sample_rate,
                    bits_per_sample=metas[s].streaminfo.bits_per_sample,
                    max_blocksize=stride, channels=nch, max_frames=Gc)
                if st < 0:
                    raise ValueError(f"stream {s}: rice wire status {st}")
                if n < Gc:
                    live[s] = False
                ob += ov.count.value
                cb += cf.count.value
                eb += es.count.value
                bb += b1 - b0
            ocap = max(ocap, ob)
            ccap = max(ccap, cb)
            ecap = max(ecap, eb)
            bcap = max(bcap, bb)
            g += 1
        return (max(256, ocap + 8), max(64, ccap + 8), max(64, ecap + 8),
                -(-(bcap + 64) // 4096) * 4096, g)

    OCAP, CCAP, ECAP, BITCAP, ngroups = survey()

    jitted = functools.partial(synthesise_group_rice_jit, num_channels=nch)

    pos = [m.header_bytes * 8 for m in metas]
    live = [True] * S
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]

    def sink(pcm, meta_rows):                  # (S*Gc, nch, stride)
        for s, n, sizes in meta_rows:
            for f in range(n):
                outs[s].append(pcm[s * Gc + f, :, :sizes[f]])

    drainer = _SU.ThreadedDrainer(sink)

    while any(live):
        bits = np.zeros(BITCAP, np.uint8)
        gcur = np.zeros((Bf, SLOTS), np.int32)
        gk = np.full((Bf, SLOTS), -1, np.int8)
        warm = np.zeros((Bf, 32), np.int32)
        coeffs = np.zeros((Bf, 32), np.int32)
        shift = np.zeros(Bf, np.int32)
        order = np.zeros(Bf, np.int32)
        wasted = np.zeros(Bf, np.int32)
        assign = np.zeros(S * Gc, np.int32)
        ov = native.RiceOverflow(OCAP)
        cf = native.RiceConstFill(CCAP)
        es = native.EscapeList(ECAP)
        bbase = 0
        meta_rows = []
        for s in range(S):
            if not live[s]:
                continue
            r0 = s * Gc * nch
            oc0 = ov.count.value
            n, pos[s], st, b, (b0, b1) = native.flac_parse_group_rice(
                streams[s], pos[s], gcur[r0:r0 + Gc * nch],
                gk[r0:r0 + Gc * nch], warm[r0:r0 + Gc * nch], scr,
                ov, cf, es, r0,
                sample_rate=metas[s].streaminfo.sample_rate,
                bits_per_sample=metas[s].streaminfo.bits_per_sample,
                max_blocksize=stride, channels=nch, max_frames=Gc)
            if st < 0:
                raise ValueError(f"stream {s}: rice wire status {st}")
            nb = b1 - b0
            # NOTE: this cursor-rebase wiring mirrors bench.py's merged
            # slab loop (which writes into slab-backed views) — changes
            # here must be mirrored there; both sides are gated by
            # bit-exact tests (tests/test_flac_serving.py, bench --smoke).
            bits[bbase:bbase + nb] = np.frombuffer(streams[s], np.uint8,
                                                   nb, b0)
            if bbase:
                gsl = gcur[r0:r0 + Gc * nch]
                gsl[gk[r0:r0 + Gc * nch] >= 0] += bbase * 8
                ov.cur[oc0:ov.count.value] += bbase * 8
            bbase += nb
            rows = n * nch
            coeffs[r0:r0 + rows] = b["coeffs"][:rows]
            shift[r0:r0 + rows] = b["shift"][:rows]
            order[r0:r0 + rows] = b["order"][:rows]
            wasted[r0:r0 + rows] = b["wasted"][:rows]
            assign[s * Gc:s * Gc + n] = b["assign"][:n]
            meta_rows.append((s, n, b["blocksize"][:n].copy()))
            if n < Gc:
                live[s] = False
        if mesh is not None:
            rows = lambda a: serving_put(mesh, a, 0)     # noqa: E731
            repl = lambda a: serving_put(mesh, a)        # noqa: E731
            pcm = jitted(repl(bits), rows(gcur), rows(gk), repl(ov.cur),
                         repl(ov.k), repl(ov.mode), repl(ov.cnt),
                         repl(ov.row), repl(ov.pos), repl(cf.row),
                         repl(cf.val), repl(cf.n), rows(warm),
                         repl(es.row), repl(es.pos), repl(es.val),
                         rows(coeffs), rows(shift), rows(order),
                         rows(wasted), rows(assign))
        else:
            pcm = jitted(bits, gcur, gk, ov.cur, ov.k, ov.mode, ov.cnt,
                         ov.row, ov.pos, cf.row, cf.val, cf.n, warm,
                         es.row, es.pos, es.val, coeffs, shift, order,
                         wasted, assign)
        drainer.put(lambda p=pcm: np.asarray(p), meta_rows)
    drainer.close()
    return [np.concatenate(o, axis=1) if o else np.zeros((nch, 0), np.int32)
            for o in outs]
