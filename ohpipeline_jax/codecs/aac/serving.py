"""Multi-stream batched device AAC-LC decode over the zigzag-nibble
wire — bench.py's AAC half as a framework API (sibling of
codecs/flac/serving.py, opus/celt_jax and vorbis/vorbis_jax's
*_streams_device functions).

ADTS streams sharing a sample rate and channel count decode in groups:
the native unpacker (native.aac_prepare_rows_zz) lays quantized
coefficients at their spectral positions as zigzag nibbles with
per-band scalefactor bytes and M/S bitmasks, short-window rows pool
per-coefficient scalefactors, |q|>7 values become escape triples,
TNS-only rows emit device-side filter conditioning planes, and the
remaining exceptional rows (PNS/intensity/short-specials) ride a
host-prepared f32 side plane.  ONE jitted scan-free program
(synthesis.decode_chunk_zz: elementwise wire decode + three
matmuls + shifted-slice overlap-add) then synthesises every stream's
frames, with the overlap state carried across groups.

Conformance: matches the host per-frame decode (decode_adts, itself
~1 LSB vs the fdk oracle) within small f32 bounds —
tests/test_aac_serving.py.  Reference displaced: the per-stream
aacDecoder_DecodeFrame loop over
/root/reference/thirdparty/fdk-aac/libAACdec, re-shaped for batched
serving.

HE-AAC v1 gets the same serving shape in decode_he_streams_device:
all streams' channels vmapped through one spec-mode SBR program
dispatch per group (native payload parse + dequant per stream on the
host, fused LC core + QMF/HF/envelope on device).
"""

from __future__ import annotations

import numpy as np

from .. import _serving_util as _SU
from .bitstream import parse_adts_header


def decode_he_streams_device(streams: list, frames_per_group: int = 48,
                             mesh=None):
    """Multi-stream batched device HE-AAC v1: every stream's channels
    ride ONE spec-mode SBR program dispatch per group (the fused LC
    core + QMF/HF/envelope chain in sbr_jax vmapped over S*C channels),
    amortizing per-dispatch latency across streams — the serving shape
    (sibling of decode_aac_streams_device).

    streams: ADTS HE-AAC v1 files (bytes) sharing sample rate, channel
    count and SBR header configuration (one compiled program serves the
    batch; mismatched headers raise).  Parametric-stereo (v2) streams
    are rejected — serve those through CodecAacAdts, whose PS chain is
    per-stream.  Hostile/irregular streams (missing payloads, header
    changes mid-stream) also raise: this is the throughput API; the
    codec path is the resilient one.  Returns [(channels, nsamples)
    int32 PCM] per stream at the doubled rate.

    Reference displaced: the per-stream aacDecoder_DecodeFrame +
    libSBRdec applySBR loop (thirdparty/fdk-aac/libSBRdec/src/
    sbrdecoder.cpp), re-shaped for batched serving."""
    import jax.numpy as jnp

    from ... import native
    from . import synthesis as SYN
    from . import sbr_jax
    from .sbr import SbrDecoder

    hdrs = [parse_adts_header(s) for s in streams]
    if any(h is None for h in hdrs):
        raise ValueError("not an ADTS stream")
    nch = hdrs[0].channels
    rate = hdrs[0].sample_rate
    ri = hdrs[0].rate_index
    for h in hdrs[1:]:
        if (h.channels, h.sample_rate) != (nch, rate):
            raise ValueError("device batch needs uniform rate/channels")
    S = len(streams)
    G = frames_per_group
    SC = S * nch

    # --- survey: per-group escape/side/short/TNS requirements ----------
    esc_cap = side_cap = ssf_cap = tns_cap = 0
    pos = [0] * S
    live = [True] * S
    pbuf = None
    while any(live):
        eb = sb = hb = tb = 0
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], b = native.aac_parse_group_sbr(
                streams[s], pos[s], channels=nch, max_frames=G,
                out=pbuf)
            pbuf = b
            if n < G:
                live[s] = False
            if n == 0:
                continue
            q = b["quant"][:n * nch]
            eb += int((np.abs(q) > 7).sum())
            exotic = (b["cb"][:n * nch] >= 13).any(axis=1)
            has_tns = b["tnsn"][:n * nch].any(axis=1)
            sb += int(exotic.sum())
            tb += int((has_tns & ~exotic).sum())
            hb += int((b["ics"][:n * nch, 0] == 2).sum())
        esc_cap = max(esc_cap, eb)
        side_cap = max(side_cap, sb)
        ssf_cap = max(ssf_cap, hb)
        tns_cap = max(tns_cap, tb)
    ACAP = max(256, 1 << int(np.ceil(np.log2(esc_cap + 64))))
    MAXS = int(max(8, side_cap + 8))
    SSCAP = int(max(64, ssf_cap + 8))
    TNSCAP = int(max(64, tns_cap + 8))

    W, SW = SYN.window_bank()
    consts = (jnp.asarray(SYN._imdct_matrix(2048)),
              jnp.asarray(SYN._imdct_matrix(256)),
              jnp.asarray(W), jnp.asarray(SW),
              jnp.asarray(SYN.sf_expand_matrix(ri)))

    decs = [SbrDecoder(rate) for _ in range(S)]
    runner = None
    pos = [0] * S
    live = [True] * S
    pshape = [np.zeros(nch, np.int32) for _ in range(S)]
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]
    hdr0 = None

    def sink(pcm, counts_g):               # (SC, F*2048) int32
        for s, n in counts_g:
            if n:
                outs[s].append(pcm[s * nch:(s + 1) * nch, :n * 2048])

    drainer = _SU.ThreadedDrainer(sink)

    while any(live):
        zz = dict(q4=np.zeros((G, SC, 512), np.uint8),
                  sfb=np.zeros((G, SC, 64), np.uint8),
                  msb=np.zeros((G, SC // 2, 128), np.uint8),
                  opx=np.zeros((G, SC), np.uint8),
                  epak=np.full(ACAP, -1, np.int32),
                  eva2=np.zeros(ACAP, np.int16),
                  side=np.zeros((MAXS, 1024), np.float32),
                  srow=np.full(MAXS, -1, np.int32),
                  consts=consts)
        esc = native.EscapeList(ACAP)
        ssfv = native.ShortSfPool(SSCAP)
        tnsv = native.TnsPool(TNSCAP)
        n_side = 0
        per_ch: list = [([], [], []) for _ in range(SC)]
        counts_g = []
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], b = native.aac_parse_group_sbr(
                streams[s], pos[s], channels=nch, max_frames=G,
                out=pbuf)
            pbuf = b
            if n < G:
                live[s] = False
            counts_g.append((s, n))
            if n == 0:
                continue
            # LC core onto the zigzag-nibble wire (shared with the
            # AAC-LC serving path; see the NOTE there about mirroring)
            special = native.aac_prepare_rows_zz(
                b, n, G, nch, pshape[s], esc, ssfv,
                q4=zz["q4"], sfb=zz["sfb"], msb=zz["msb"],
                opx=zz["opx"], col0=s * nch, max_special=G * nch,
                tns=tnsv)
            if special is None:
                raise ValueError("zz capacity exceeded (survey bug)")
            if len(special):
                frames = np.unique(np.asarray(special) // nch)
                k = len(frames)
                idx = np.asarray([f * nch + cc for f in frames
                                  for cc in range(nch)])
                sub = {key: b[key][idx] for key in
                       ("ics", "cb", "sf", "quant", "tnsn", "tnsp",
                        "tnsc")}
                sub["msmask"] = b["msmask"][frames]
                sub["rate_index"] = b["rate_index"]
                sp, _ = SYN.prepare_group(sub, k, nch,
                                          np.zeros(nch, np.int32))
                fmap = {int(f): j for j, f in enumerate(frames)}
                for r in special:
                    f, cc = divmod(int(r), nch)
                    zz["side"][n_side] = sp[fmap[f], cc]
                    zz["srow"][n_side] = f * SC + s * nch + cc
                    n_side += 1
            # SBR payloads: per-stream delta-coded parse + dequant
            dec = decs[s]
            for f in range(n):
                pl = b["sbr"][f]
                if pl is None:
                    raise ValueError("frame without SBR payload")
                payload, nbits, crc = pl
                chans, coupling = dec.parse_payload(
                    payload, nbits, stereo=(nch == 2), crc=crc)
                if hdr0 is not None and dec.header != hdr0:
                    raise ValueError("SBR header changed mid-stream")
                if chans[0].ps is not None:
                    raise ValueError("PS (v2) stream: use CodecAacAdts")
                EQ = [dec.dequant(dec.header, chans[i].grid,
                                  chans[i].env, chans[i].noise)
                      for i in range(nch)]
                if nch == 2 and coupling:
                    a = EQ[0][2]
                    (EL, QL), (ER, QR) = dec.unmap_coupled(
                        EQ[0][0], EQ[0][1], chans[1].env,
                        chans[1].noise, a)
                    EQ = [(EL, QL, a), (ER, QR, a)]
                for c in range(nch):
                    dl, el, ql = per_ch[s * nch + c]
                    dl.append(chans[c])
                    el.append(EQ[c][0])
                    ql.append(EQ[c][1])
        ne = esc.count.value
        zz["epak"][:ne] = esc.row[:ne] * 1024 + esc.pos[:ne]
        zz["eva2"][:ne] = esc.val[:ne]
        zz["ssf"], zz["ssr"] = ssfv.sf, ssfv.row
        zz["tfi"], zz["tco"] = tnsv.tfi, tnsv.tco
        zz["tdir"], zz["trow"] = tnsv.tdir, tnsv.row
        if runner is None:
            lead = next((s for s in range(S)
                         if decs[s].header is not None), None)
            if lead is None:
                raise ValueError("no SBR header in any stream")
            hdr0 = decs[lead].header
            for s in range(S):
                if decs[s].header is not None \
                        and decs[s].header != hdr0:
                    raise ValueError(
                        "device batch needs one SBR header config")
            runner = sbr_jax.SbrDeviceRunner(decs[lead], nch=SC)
        # dead/short channels: empty cond lists leave their frames
        # inactive (the device passes the zero core through untouched)
        # and their trailing output is sliced off in drain()
        if mesh is not None:
            # stream-axis dp sharding of the zz wire planes; escape/
            # side lists + consts replicate (parallel.serving_put)
            from ...parallel import serving_put
            for k in ("q4", "sfb", "msb", "opx"):
                zz[k] = serving_put(mesh, zz[k], 1)
            for k in ("epak", "eva2", "side", "srow", "ssf", "ssr",
                      "tfi", "tco", "tdir", "trow"):
                zz[k] = serving_put(mesh, zz[k])
        resolve = runner.decode_group_multi_lazy_zz(
            zz, per_ch, np.zeros((SC, 1024), np.float32))
        drainer.put(resolve, counts_g)
    drainer.close()
    return [np.concatenate(o, axis=1) if o else
            np.zeros((nch, 0), np.int32) for o in outs]


def decode_aac_streams_device(streams: list, frames_per_group: int = 64,
                              mesh=None):
    """streams: ADTS AAC-LC files (bytes) sharing rate and channel
    count.  Returns [(channels, nsamples) int32 PCM] per stream,
    clipped to the int16 range like the host decode path (fdk also
    saturates inter-sample overs at the 16-bit output).

    With ``mesh`` the (G, S*C, ...) wire planes shard their stream
    axis over dp (parallel.serving_put); results match mesh=None."""
    import jax
    import jax.numpy as jnp

    from ... import native
    from ...parallel import serving_put
    from . import synthesis as ASYN

    hdrs = [parse_adts_header(s) for s in streams]
    if any(h is None for h in hdrs):
        raise ValueError("not an ADTS stream")
    nch = hdrs[0].channels
    ri = hdrs[0].rate_index
    for h in hdrs[1:]:
        if (h.channels, h.rate_index) != (nch, ri):
            raise ValueError("device batch needs uniform rate/channels")
    S = len(streams)
    G = frames_per_group
    SC = S * nch

    # --- survey: per-group escape/side/short/TNS requirements ----------
    esc_cap = side_cap = ssf_cap = tns_cap = 0
    pos = [0] * S
    live = [True] * S
    pbuf = None                  # reused parse arrays (~1 MB/call)
    while any(live):
        eb = sb = hb = tb = 0
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], b = native.aac_parse_group(streams[s], pos[s],
                                                  channels=nch,
                                                  max_frames=G, out=pbuf)
            pbuf = b
            if n < G:
                live[s] = False
            if n == 0:
                continue
            q = b["quant"][:n * nch]
            eb += int((np.abs(q) > 7).sum())
            exotic = (b["cb"][:n * nch] >= 13).any(axis=1)
            has_tns = b["tnsn"][:n * nch].any(axis=1)
            sb += int(exotic.sum())
            tb += int((has_tns & ~exotic).sum())
            hb += int((b["ics"][:n * nch, 0] == 2).sum())
        esc_cap = max(esc_cap, eb)
        side_cap = max(side_cap, sb)
        ssf_cap = max(ssf_cap, hb)
        tns_cap = max(tns_cap, tb)
    ACAP = max(256, 1 << int(np.ceil(np.log2(esc_cap + 64))))
    MAXS = int(max(8, side_cap + 8))
    SSCAP = int(max(64, ssf_cap + 8))
    TNSCAP = int(max(64, tns_cap + 8))

    W, SW = ASYN.window_bank()
    consts = [jnp.asarray(ASYN._imdct_matrix(2048)),
              jnp.asarray(ASYN._imdct_matrix(256)),
              jnp.asarray(W), jnp.asarray(SW),
              jnp.asarray(ASYN.sf_expand_matrix(ri))]
    fn = jax.jit(ASYN.decode_chunk_zz)

    pos = [0] * S
    live = [True] * S
    pshape = [np.zeros(nch, np.int32) for _ in range(S)]
    ov = jnp.asarray(np.zeros((SC, 1024), np.float32))
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]

    def sink(pcm, counts_g):                   # (G, SC, 1024)
        for s, n in counts_g:
            if n:
                cols = pcm[:n, s * nch:(s + 1) * nch]
                pcm16 = np.clip(np.rint(cols), -32768,
                                32767).astype(np.int32)
                outs[s].append(pcm16.transpose(1, 0, 2).reshape(nch, -1))

    drainer = _SU.ThreadedDrainer(sink)

    while any(live):
        q4 = np.zeros((G, SC, 512), np.uint8)
        sfb = np.zeros((G, SC, 64), np.uint8)
        msb = np.zeros((G, SC // 2, 128), np.uint8)
        opx = np.zeros((G, SC), np.uint8)
        epak = np.full(ACAP, -1, np.int32)
        eva2 = np.zeros(ACAP, np.int16)
        side = np.zeros((MAXS, 1024), np.float32)
        srow = np.full(MAXS, -1, np.int32)
        esc = native.EscapeList(ACAP)
        ssfv = native.ShortSfPool(SSCAP)
        tnsv = native.TnsPool(TNSCAP)
        n_side = 0
        counts_g = []
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], b = native.aac_parse_group(streams[s], pos[s],
                                                  channels=nch,
                                                  max_frames=G, out=pbuf)
            pbuf = b
            if n < G:
                live[s] = False
            counts_g.append((s, n))
            if n == 0:
                continue
            # NOTE: this special-row side-plane prep mirrors bench.py's
            # merged-slab wiring (which writes into slab-backed views
            # instead of fresh arrays) — changes here must be mirrored
            # there; both sides are gated by bit-exact/LSB tests.
            special = native.aac_prepare_rows_zz(
                b, n, G, nch, pshape[s], esc, ssfv,
                q4=q4, sfb=sfb, msb=msb, opx=opx, col0=s * nch,
                max_special=G * nch, tns=tnsv)
            if special is None:
                raise ValueError("zz capacity exceeded (survey bug)")
            if len(special):
                frames = np.unique(np.asarray(special) // nch)
                k = len(frames)
                idx = np.asarray([f * nch + cc for f in frames
                                  for cc in range(nch)])
                sub = {key: (val[idx] if key not in
                             ("msmask", "rate_index")
                             else (val[frames] if key == "msmask"
                                   else val))
                       for key, val in b.items()}
                sp, _ = ASYN.prepare_group(sub, k, nch,
                                           np.zeros(nch, np.int32))
                fmap = {int(f): j for j, f in enumerate(frames)}
                for r in special:
                    f, cc = divmod(int(r), nch)
                    side[n_side] = sp[fmap[f], cc]
                    srow[n_side] = f * SC + s * nch + cc
                    n_side += 1
        ne = esc.count.value
        epak[:ne] = esc.row[:ne] * 1024 + esc.pos[:ne]
        eva2[:ne] = esc.val[:ne]
        if mesh is not None:
            q4, sfb, msb, opx = (serving_put(mesh, a, 1)
                                 for a in (q4, sfb, msb, opx))
            ov = serving_put(mesh, ov, 0)
            epak, eva2, side, srow = (serving_put(mesh, a)
                                      for a in (epak, eva2, side, srow))
        pcm, ov = fn(q4, sfb, ssfv.sf, ssfv.row, msb, opx,
                     epak, None, eva2, side, srow, ov, *consts,
                     tnsv.tfi, tnsv.tco, tnsv.tdir, tnsv.row)
        drainer.put(lambda p=pcm: np.asarray(p), counts_g)
    drainer.close()
    return [np.concatenate(o, axis=1) if o else
            np.zeros((nch, 0), np.int32) for o in outs]
