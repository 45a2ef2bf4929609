"""Device wire formats (bench fast paths) must reconstruct exactly:
FLAC 12-bit pack + escapes + warm-up == int16 rows; AAC sparse
mask/ranked-values/escapes == dense quant path."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs import aac, flac
from ohpipeline_jax.codecs.aac import synthesis as ASYN
from ohpipeline_jax.codecs.flac import frames as FF
from ohpipeline_jax.codecs.flac import _synthesise_group, _synthesise_group12

import jax.numpy as jnp

pytestmark = pytest.mark.skipif(
    not (native.have_flac_unpack() and native.have_aac_unpack()),
    reason="native unpackers unavailable")


def _noisy_track(seconds=3.0, rate=44100, seed=5, noise=0.2):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = (np.sin(2 * np.pi * 700 * t) * 0.5
         + rng.standard_normal(n) * noise)          # noisy -> escapes
    x[rate // 2:rate // 2 + 300] += 0.9             # transient
    s = np.stack([x, np.roll(x, 11)])
    return np.clip(np.rint(s * 20000), -32768, 32767).astype(np.int32)


def test_flac_pack12_roundtrip():
    track = _noisy_track()
    data = flac.encode_flac(track, 44100, 16)
    m = FF.parse_metadata(data)
    si = m.streaminfo
    G, nch = 8, 2
    B = G * nch
    stride = si.max_blocksize
    scratch = np.zeros((B, stride), np.int32)
    d16 = np.empty((B, stride), np.int16)
    pack = np.zeros((B, stride * 3 // 2), np.uint8)
    warm = np.zeros((B, 32), np.int32)
    esc = native.EscapeList(200000)
    pos = pos12 = m.header_bytes * 8
    steps = 0
    while True:
        n, pos, _s, b16, ovf = native.flac_parse_group16(
            data, pos, d16, scratch, sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample, max_blocksize=stride,
            channels=nch, max_frames=G)
        if n == 0:
            break
        ref16 = d16.copy()
        meta16 = {k: b16[k].copy() for k in ("coeffs", "shift", "order",
                                             "wasted", "assign")}
        esc.reset()
        n2, pos12, st, b12 = native.flac_parse_group12(
            data, pos12, pack, warm, scratch, esc, 0,
            sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample, max_blocksize=stride,
            channels=nch, max_frames=G)
        assert n2 == n and st == 0
        pcm16 = np.asarray(_synthesise_group(
            jnp.asarray(ref16), jnp.asarray(meta16["coeffs"]),
            jnp.asarray(meta16["shift"]), jnp.asarray(meta16["order"]),
            jnp.asarray(meta16["wasted"]), jnp.asarray(meta16["assign"]),
            nch))
        pcm12 = np.asarray(_synthesise_group12(
            jnp.asarray(pack), jnp.asarray(warm), jnp.asarray(esc.row),
            jnp.asarray(esc.pos), jnp.asarray(esc.val),
            jnp.asarray(b12["coeffs"]), jnp.asarray(b12["shift"]),
            jnp.asarray(b12["order"]), jnp.asarray(b12["wasted"]),
            jnp.asarray(b12["assign"]), nch))
        np.testing.assert_array_equal(pcm12, pcm16)
        steps += 1
    assert steps >= 2
    assert esc.count.value > 0     # the noisy content must exercise escapes


def test_flac_zz_matches_pack12():
    from ohpipeline_jax.codecs.flac import _synthesise_group_zz
    track = _noisy_track()
    data = flac.encode_flac(track, 44100, 16)
    m = FF.parse_metadata(data)
    si = m.streaminfo
    G, nch = 8, 2
    B = G * nch
    stride = si.max_blocksize
    scratch = np.zeros((B, stride), np.int32)
    pack = np.zeros((B, stride * 3 // 2), np.uint8)
    warm = np.zeros((B, 32), np.int32)
    lo = np.zeros((B, stride), np.uint8)
    hi = np.zeros((B, stride // 2), np.uint8)
    warm_z = np.zeros((B, 32), np.int32)
    esc = native.EscapeList(200000)
    escz = native.EscapeList(200000)
    pos = posz = m.header_bytes * 8
    steps = 0
    while True:
        esc.reset()
        n, pos, st, b12 = native.flac_parse_group12(
            data, pos, pack, warm, scratch, esc, 0,
            sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
            max_blocksize=stride, channels=nch, max_frames=G)
        if n == 0:
            break
        escz.reset()
        nz, posz, stz, bz = native.flac_parse_group_zz(
            data, posz, lo, hi, warm_z, scratch, escz, 0,
            sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
            max_blocksize=stride, channels=nch, max_frames=G)
        assert nz == n and stz == 0
        pcm12 = np.asarray(_synthesise_group12(
            jnp.asarray(pack), jnp.asarray(warm), jnp.asarray(esc.row),
            jnp.asarray(esc.pos), jnp.asarray(esc.val),
            jnp.asarray(b12["coeffs"]), jnp.asarray(b12["shift"]),
            jnp.asarray(b12["order"]), jnp.asarray(b12["wasted"]),
            jnp.asarray(b12["assign"]), nch))
        pcmz = np.asarray(_synthesise_group_zz(
            jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(warm_z),
            jnp.asarray(escz.row), jnp.asarray(escz.pos),
            jnp.asarray(escz.val),
            jnp.asarray(bz["coeffs"]), jnp.asarray(bz["shift"]),
            jnp.asarray(bz["order"]), jnp.asarray(bz["wasted"]),
            jnp.asarray(bz["assign"]), nch))
        np.testing.assert_array_equal(pcmz, pcm12)
        steps += 1
    assert steps >= 2
    assert escz.count.value > 0


def test_fast_cbrt_and_exp2():
    import jax
    x = jnp.asarray(np.arange(1, 8192, dtype=np.float32))
    got = np.asarray(jax.jit(ASYN._fast_cbrt)(x))
    np.testing.assert_allclose(got, np.cbrt(np.arange(1, 8192)),
                               rtol=3e-7)
    k = jnp.asarray(np.arange(-120, 156, dtype=np.int32))
    got2 = np.asarray(jax.jit(ASYN._exp2_quarter)(k))
    np.testing.assert_allclose(got2,
                               np.exp2(np.arange(-120, 156) / 4.0),
                               rtol=3e-7)


ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "aac_oracle")


def test_aac_sparse_matches_dense():
    if not os.path.exists(ORACLE):
        pytest.skip("aac oracle not built")
    track = _noisy_track(4.0, noise=0.1)
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "128000"], check=True, capture_output=True)
        data = open(fout, "rb").read()

    nch, F = 2, 32
    SC = nch
    pos = posd = 0
    cfg = native.AacCfgMap(16)
    cfgd = native.AacCfgMap(16)
    ps = np.zeros(nch, np.int32)
    psd = np.zeros(nch, np.int32)
    W, SW = ASYN.window_bank()
    consts = (jnp.asarray(ASYN._imdct_matrix(2048)),
              jnp.asarray(ASYN._imdct_matrix(256)),
              jnp.asarray(W), jnp.asarray(SW))
    ov_d = jnp.zeros((SC, 1024), jnp.float32)
    ov_s = jnp.zeros((SC, 1024), jnp.float32)
    steps = 0
    while steps < 6:
        n, pos, b = native.aac_parse_group(data, pos, channels=nch,
                                           max_frames=F)
        if n == 0:
            break
        posd = pos
        # dense
        q16 = np.zeros((F, SC, 1024), np.int16)
        sf16 = np.zeros((F, SC, 128), np.int16)
        coded = np.zeros((F, SC, 128), np.uint8)
        ci_d = np.zeros((F, SC), np.int32)
        ms_d = np.zeros((F, SC // 2, 128), np.uint8)
        op_d = np.zeros((F, SC), np.int32)
        rd = native.aac_prepare_rows(b, n, F, nch, psd, cfgd,
                                     quant16=q16, sf16=sf16, coded=coded,
                                     cfg_idx=ci_d, ms_flag=ms_d,
                                     opidx=op_d, col0=0)
        assert rd is not None
        # sparse
        mask = np.zeros((F, SC, 128), np.uint8)
        vals = np.zeros((F, SC, 768), np.int8)
        sf8 = np.zeros((F, SC, 128), np.uint8)
        ci_s = np.zeros((F, SC), np.int32)
        ms_s = np.zeros((F, SC // 2, 128), np.uint8)
        op_s = np.zeros((F, SC), np.int32)
        esc = native.EscapeList(4096)
        rs = native.aac_prepare_rows_sparse(b, n, F, nch, ps, cfg, esc,
                                            mask=mask, vals=vals, sf_u8=sf8,
                                            cfg_idx=ci_s, ms_flag=ms_s,
                                            opidx=op_s, col0=0)
        assert rs is not None
        np.testing.assert_array_equal(ms_s, ms_d)
        np.testing.assert_array_equal(op_s, op_d)
        np.testing.assert_array_equal(rs, rd[0])

        # side rows (special frames) via the python path, both identical
        side = np.zeros((16, 1024), np.float32)
        srow = np.full(16, -1, np.int32)
        j = 0
        for f in rs:
            sub = {k: (v[f * nch:(f + 1) * nch]
                       if k not in ("msmask", "rate_index")
                       else (v[f:f + 1] if k == "msmask" else v))
                   for k, v in b.items()}
            sp, _ = ASYN.prepare_group(sub, 1, nch, np.zeros(nch, np.int32))
            for c in range(nch):
                side[j] = sp[0, c]
                srow[j] = int(f) * SC + c
                j += 1
        perm_d, band_d = aac.cfg_tables(cfgd.as_dict(), ncfg=16)
        perm_s, band_s = aac.cfg_tables(cfg.as_dict(), ncfg=16)
        pcm_d, ov_d = ASYN.dequant_filterbank(
            jnp.asarray(q16), jnp.asarray(sf16), jnp.asarray(coded),
            jnp.asarray(ci_d), jnp.asarray(perm_d), jnp.asarray(band_d),
            jnp.asarray(ms_d), jnp.asarray(side), jnp.asarray(srow),
            jnp.asarray(op_d), ov_d, *consts)
        pcm_s, ov_s = ASYN.dequant_filterbank_sparse(
            jnp.asarray(mask), jnp.asarray(vals), jnp.asarray(esc.row),
            jnp.asarray(esc.pos), jnp.asarray(esc.val), jnp.asarray(sf8),
            jnp.asarray(ci_s), jnp.asarray(perm_s), jnp.asarray(band_s),
            jnp.asarray(ms_s), jnp.asarray(side), jnp.asarray(srow),
            jnp.asarray(op_s), ov_s, *consts)
        np.testing.assert_allclose(np.asarray(pcm_s), np.asarray(pcm_d),
                                   atol=1e-4, rtol=0)
        steps += 1
    assert steps >= 4


def test_aac_zz_matches_dense():
    """The zigzag-nibble wire + scan-free chunk decoder must match the
    dense per-step device path on real encoded content."""
    if not os.path.exists(ORACLE):
        pytest.skip("aac oracle not built")
    import jax
    track = _noisy_track(4.0, noise=0.1)
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "128000"], check=True, capture_output=True)
        data = open(fout, "rb").read()

    nch, F = 2, 96                     # one chunk of 96 frames
    SC = nch
    cfgd = native.AacCfgMap(16)
    psd = np.zeros(nch, np.int32)
    psz = np.zeros(nch, np.int32)
    W, SW = ASYN.window_bank()
    consts = (jnp.asarray(ASYN._imdct_matrix(2048)),
              jnp.asarray(ASYN._imdct_matrix(256)),
              jnp.asarray(W), jnp.asarray(SW))
    n, _pos, b = native.aac_parse_group(data, 0, channels=nch, max_frames=F)
    assert n >= 64
    # dense reference path
    q16 = np.zeros((F, SC, 1024), np.int16)
    sf16 = np.zeros((F, SC, 128), np.int16)
    coded = np.zeros((F, SC, 128), np.uint8)
    ci_d = np.zeros((F, SC), np.int32)
    ms_d = np.zeros((F, SC // 2, 128), np.uint8)
    op_d = np.zeros((F, SC), np.int32)
    rd = native.aac_prepare_rows(b, n, F, nch, psd, cfgd,
                                 quant16=q16, sf16=sf16, coded=coded,
                                 cfg_idx=ci_d, ms_flag=ms_d,
                                 opidx=op_d, col0=0, max_special=F)
    assert rd is not None
    special = rd[0]
    # zz wire
    q4 = np.zeros((F, SC, 512), np.uint8)
    sfb = np.zeros((F, SC, 64), np.uint8)
    msb = np.zeros((F, SC // 2, 128), np.uint8)
    opx = np.zeros((F, SC), np.uint8)
    esc = native.EscapeList(65536)
    ssf = native.ShortSfPool(F * nch)
    rz = native.aac_prepare_rows_zz(b, n, F, nch, psz, esc, ssf,
                                    q4=q4, sfb=sfb, msb=msb, opx=opx,
                                    col0=0, max_special=F * nch)
    assert rz is not None
    # zz flags per (frame, channel); the dense path flags whole frames
    np.testing.assert_array_equal(np.unique(np.asarray(rz) // nch), special)
    np.testing.assert_array_equal(opx.astype(np.int32), op_d)
    assert esc.count.value > 0

    # side rows (special frames), shared between both paths
    nside = max(1, len(special) * nch)
    side_f = np.zeros((nside, 1024), np.float32)
    srow = np.full(nside, -1, np.int32)
    j = 0
    for f in special:
        sub = {k: (v[f * nch:(f + 1) * nch]
                   if k not in ("msmask", "rate_index")
                   else (v[f:f + 1] if k == "msmask" else v))
               for k, v in b.items()}
        sp, _ = ASYN.prepare_group(sub, 1, nch, np.zeros(nch, np.int32))
        for c in range(nch):
            side_f[j] = sp[0, c]
            srow[j] = int(f) * SC + c
            j += 1

    perm_d, band_d = aac.cfg_tables(cfgd.as_dict(), ncfg=16)
    ov0 = jnp.zeros((SC, 1024), jnp.float32)
    pcm_d, ov_d = ASYN.dequant_filterbank(
        jnp.asarray(q16), jnp.asarray(sf16), jnp.asarray(coded),
        jnp.asarray(ci_d), jnp.asarray(perm_d), jnp.asarray(band_d),
        jnp.asarray(ms_d), jnp.asarray(side_f), jnp.asarray(srow),
        jnp.asarray(op_d), ov0, *consts)
    E_sf = ASYN.sf_expand_matrix(b["rate_index"])
    pcm_z, ov_z = jax.jit(ASYN.decode_chunk_zz)(
        jnp.asarray(q4), jnp.asarray(sfb), jnp.asarray(ssf.sf),
        jnp.asarray(ssf.row), jnp.asarray(msb),
        jnp.asarray(opx), jnp.asarray(esc.row), jnp.asarray(esc.pos),
        jnp.asarray(esc.val), jnp.asarray(side_f),
        jnp.asarray(srow), ov0, *consts, jnp.asarray(E_sf))
    np.testing.assert_allclose(np.asarray(pcm_z), np.asarray(pcm_d),
                               atol=0.05, rtol=0)
    np.testing.assert_allclose(np.asarray(ov_z), np.asarray(ov_d),
                               atol=0.05, rtol=0)
    # and the float64 reference of the same wire agrees with the device
    ref, ov_r = ASYN.decode_chunk_zz_reference(
        q4, sfb, ssf.sf, ssf.row, msb, opx, esc.row, esc.pos, esc.val,
        side_f, srow, np.zeros((SC, 1024), np.float32), E_sf)
    assert float(np.abs(np.asarray(pcm_z) - ref).max()) <= 0.05


def test_aac_zz_tns_pool_matches_side_path():
    """TNS applied on device via the pooled conditioning planes
    (native TnsPool + synthesis.apply_tns_zz masked scans) must match
    the host-prepared side-spectrum path on real TNS-heavy content."""
    if not os.path.exists(ORACLE):
        pytest.skip("aac oracle not built")
    import jax
    track = _noisy_track(4.0, noise=0.1)
    # transients force TNS on
    t = np.arange(track.shape[1]) / 44100.0
    track = track.astype(np.float64)
    for s in range(0, track.shape[1] - 900, 4410):
        track[:, s:s + 800] += (np.sign(np.sin(2 * np.pi * 37 * t[:800]))
                                * np.exp(-t[:800] * 300) * 9000)
    track = np.clip(track, -32768, 32767).astype(np.int32)
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "128000"], check=True, capture_output=True)
        data = open(fout, "rb").read()
    nch, F = 2, 96
    SC = nch
    W, SW = ASYN.window_bank()
    consts = (jnp.asarray(ASYN._imdct_matrix(2048)),
              jnp.asarray(ASYN._imdct_matrix(256)),
              jnp.asarray(W), jnp.asarray(SW))
    n, _pos, b = native.aac_parse_group(data, 0, channels=nch, max_frames=F)
    assert n >= 64
    assert b["tnsn"][:n * nch].any(), "content produced no TNS"

    def prep(with_pool):
        q4 = np.zeros((F, SC, 512), np.uint8)
        sfb = np.zeros((F, SC, 64), np.uint8)
        msb = np.zeros((F, SC // 2, 128), np.uint8)
        opx = np.zeros((F, SC), np.uint8)
        esc = native.EscapeList(65536)
        ssf = native.ShortSfPool(F * nch)
        tns = native.TnsPool(F * nch) if with_pool else None
        ps = np.zeros(nch, np.int32)
        sp = native.aac_prepare_rows_zz(
            b, n, F, nch, ps, esc, ssf, q4=q4, sfb=sfb, msb=msb,
            opx=opx, col0=0, max_special=F * nch, tns=tns)
        assert sp is not None
        nside = max(1, len(sp))
        side_f = np.zeros((nside, 1024), np.float32)
        srow = np.full(nside, -1, np.int32)
        for j, r in enumerate(sp):
            f, c = divmod(int(r), nch)
            sub = {k: (v[f * nch:(f + 1) * nch]
                       if k not in ("msmask", "rate_index")
                       else (v[f:f + 1] if k == "msmask" else v))
                   for k, v in b.items()}
            spf, _ = ASYN.prepare_group(sub, 1, nch, np.zeros(nch,
                                                              np.int32))
            side_f[j] = spf[0, c]
            srow[j] = f * SC + c
        return q4, sfb, msb, opx, esc, ssf, tns, side_f, srow, sp

    ov0 = jnp.zeros((SC, 1024), jnp.float32)
    E_sf = ASYN.sf_expand_matrix(b["rate_index"])
    outs = {}
    q4a, sfba, msba, opxa, esca, ssfa, _t, sidea, srowa, spa = prep(False)
    pcm_a, _ = jax.jit(ASYN.decode_chunk_zz)(
        jnp.asarray(q4a), jnp.asarray(sfba), jnp.asarray(ssfa.sf),
        jnp.asarray(ssfa.row), jnp.asarray(msba), jnp.asarray(opxa),
        jnp.asarray(esca.row), jnp.asarray(esca.pos),
        jnp.asarray(esca.val), jnp.asarray(sidea), jnp.asarray(srowa),
        ov0, *consts, jnp.asarray(E_sf))
    q4b, sfbb, msbb, opxb, escb, ssfb, tns, sideb, srowb, spb = prep(True)
    assert tns.count.value > 0
    assert len(spb) < len(spa)        # TNS rows left the special path
    pcm_b, _ = jax.jit(ASYN.decode_chunk_zz)(
        jnp.asarray(q4b), jnp.asarray(sfbb), jnp.asarray(ssfb.sf),
        jnp.asarray(ssfb.row), jnp.asarray(msbb), jnp.asarray(opxb),
        jnp.asarray(escb.row), jnp.asarray(escb.pos),
        jnp.asarray(escb.val), jnp.asarray(sideb), jnp.asarray(srowb),
        ov0, *consts, jnp.asarray(E_sf),
        jnp.asarray(tns.tfi), jnp.asarray(tns.tco),
        jnp.asarray(tns.tdir), jnp.asarray(tns.row))
    np.testing.assert_allclose(np.asarray(pcm_b), np.asarray(pcm_a),
                               atol=0.5, rtol=0)
    # the float64 twin of the pooled path agrees too
    ref, _ = ASYN.decode_chunk_zz_reference(
        q4b, sfbb, ssfb.sf, ssfb.row, msbb, opxb, escb.row, escb.pos,
        escb.val, sideb, srowb, np.zeros((SC, 1024), np.float32), E_sf,
        tns.tfi, tns.tco, tns.tdir, tns.row)
    assert float(np.abs(np.asarray(pcm_b) - ref).max()) <= 0.5


def test_fused_parse_zz_matches_two_pass():
    """aac_parse_group_zz (fused parse + zz emission) must produce
    byte-identical wire planes, pools, escapes, specials and parse
    positions to aac_parse_group followed by aac_prepare_rows_zz —
    across chained groups (prev_shape continuity, row_base offsets)
    on content with short windows, TNS and M/S."""
    if not os.path.exists(ORACLE):
        pytest.skip("aac oracle not built")
    track = _noisy_track(4.0, noise=0.1)
    # transients force short windows + TNS on
    t = np.arange(track.shape[1]) / 44100.0
    track = track.astype(np.float64)
    for s in range(0, track.shape[1] - 900, 4410):
        track[:, s:s + 800] += (np.sign(np.sin(2 * np.pi * 37 * t[:800]))
                                * np.exp(-t[:800] * 300) * 9000)
    track = np.clip(track, -32768, 32767).astype(np.int32)
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "128000"], check=True, capture_output=True)
        data = open(fout, "rb").read()

    nch, F = 2, 48                     # several chained groups
    SC = nch

    def slabs():
        return (np.zeros((F, SC, 512), np.uint8),
                np.zeros((F, SC, 64), np.uint8),
                np.zeros((F, SC // 2, 128), np.uint8),
                np.zeros((F, SC), np.uint8),
                native.EscapeList(65536),
                native.ShortSfPool(F * nch),
                native.TnsPool(F * nch))

    pos_a = pos_b = 0
    ps_a = np.zeros(nch, np.int32)
    ps_b = np.zeros(nch, np.int32)
    groups = 0
    while True:
        row_base = groups * 1000       # arbitrary nonzero, same both paths
        q4a, sfba, msba, opxa, esca, ssfa, tnsa = slabs()
        n_a, pos_a, b_a = native.aac_parse_group(
            data, pos_a, channels=nch, max_frames=F)
        sp_a = native.aac_prepare_rows_zz(
            b_a, n_a, F, nch, ps_a, esca, ssfa, q4=q4a, sfb=sfba,
            msb=msba, opx=opxa, col0=0, row_base=row_base,
            max_special=F * nch, tns=tnsa)
        assert sp_a is not None

        q4b, sfbb, msbb, opxb, escb, ssfb, tnsb = slabs()
        n_b, pos_b, b_b, sp_b = native.aac_parse_group_zz(
            data, pos_b, channels=nch, max_frames=F, prev_shape=ps_b,
            esc=escb, ssf=ssfb, q4=q4b, sfb=sfbb, msb=msbb, opx=opxb,
            col0=0, row_base=row_base, max_special=F * nch, tns=tnsb)
        assert sp_b is not None

        assert (n_a, pos_a) == (n_b, pos_b)
        np.testing.assert_array_equal(sp_a, sp_b)
        np.testing.assert_array_equal(ps_a, ps_b)
        for x, y in ((q4a, q4b), (sfba, sfbb), (msba, msbb),
                     (opxa, opxb)):
            np.testing.assert_array_equal(x, y)
        for pa, pb in ((esca, escb),):
            assert pa.count.value == pb.count.value
            k = pa.count.value
            np.testing.assert_array_equal(pa.row[:k], pb.row[:k])
            np.testing.assert_array_equal(pa.pos[:k], pb.pos[:k])
            np.testing.assert_array_equal(pa.val[:k], pb.val[:k])
        assert ssfa.count.value == ssfb.count.value
        k = ssfa.count.value
        np.testing.assert_array_equal(ssfa.row[:k], ssfb.row[:k])
        np.testing.assert_array_equal(ssfa.sf[:k], ssfb.sf[:k])
        assert tnsa.count.value == tnsb.count.value
        k = tnsa.count.value
        np.testing.assert_array_equal(tnsa.row[:k], tnsb.row[:k])
        np.testing.assert_array_equal(tnsa.tfi[:k], tnsb.tfi[:k])
        np.testing.assert_array_equal(tnsa.tco[:k], tnsb.tco[:k])
        np.testing.assert_array_equal(tnsa.tdir[:k], tnsb.tdir[:k])
        # dense batch planes match too (the special/side path reads them)
        for key in ("ics", "cb", "sf", "msmask", "tnsn", "tnsp", "tnsc"):
            np.testing.assert_array_equal(b_a[key], b_b[key])
        np.testing.assert_array_equal(b_a["quant"][:n_a * nch],
                                      b_b["quant"][:n_b * nch])
        groups += 1
        if n_a == 0:
            break
    assert groups >= 3
