"""SILK LP-layer parse vs reference-encoded streams (opus-1.5.2 forced
to MODE_SILK_ONLY via the oracle).  A single mis-decoded symbol
desynchronises the range coder for the rest of the packet, so parsing
hundreds of frames with coherent parameters and a plausible bit budget
is a strong structural check of the symbol schedule
(silk/decode_indices.c, decode_pulses.c, shell_coder.c, code_signs.c)."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax.codecs.opus_headers import parse_toc
from ohpipeline_jax.codecs.opus.silk import parse_silk_packet
from ohpipeline_jax.containers.ogg import OggReader

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "opus_oracle")
SILK_PROBE = os.path.join(os.path.dirname(ORACLE), "silk_probe")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="opus oracle not built")


def _probe_decode(pkts: list, fs_khz: int, channels: int, api_khz: int,
                  ms: int = 20, loss: str | None = None) -> np.ndarray:
    """Ground-truth SILK decode through the reference's silk_Decode
    (tools/silk_probe.c, built by tools/build_oracles.sh)."""
    import struct
    blob = b"".join(struct.pack("<I", len(p)) + p for p in pkts)
    cmd = [SILK_PROBE, str(fs_khz), str(channels), str(api_khz), str(ms)]
    if loss:
        cmd.append(loss)
    r = subprocess.run(cmd, input=blob, capture_output=True, check=True)
    return np.frombuffer(r.stdout, np.int16)


class _R:
    def __init__(self, b):
        self._b = b
        self._p = 0

    def read(self, n):
        out = self._b[self._p:self._p + n]
        self._p += len(out)
        return out

    def peek(self, n):
        return self._b[self._p:self._p + n]


def _silk_stream(kind: str) -> bytes:
    t = np.arange(48000 * 2) / 48000.0
    rng = np.random.default_rng(5)
    if kind == "tone":
        x = np.sin(2 * np.pi * 220 * t) \
            * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
    else:
        x = rng.standard_normal(len(t)) * 2500 \
            * (0.4 + 0.6 * (np.sin(2 * np.pi * 1.3 * t) > 0))
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "24000", "silk"],
                       check=True, capture_output=True)
        return open(fout, "rb").read()


@pytest.mark.parametrize("kind", ["tone", "pulsed_noise"])
def test_silk_packets_parse(kind):
    data = _silk_stream(kind)
    rdr = OggReader(_R(data))
    n = 0
    types = {0: 0, 1: 0, 2: 0}
    for i, p in enumerate(rdr.packets()):
        if i < 2:                      # OpusHead/OpusTags
            continue
        toc = parse_toc(p)
        assert toc.mode == "silk" and toc.frame_ms == 20
        frames = parse_silk_packet(bytes(p[1:]), toc.bandwidth)
        ix = frames[0].indices
        types[ix.signal_type] += 1
        assert len(ix.gain_indices) == 4
        assert all(0 <= g <= 63 for g in ix.gain_indices[:1])
        assert 0 <= ix.nlsf_stage1 < 32
        assert len(ix.nlsf_residuals) in (10, 16)
        assert all(-10 <= r <= 10 for r in ix.nlsf_residuals)
        if ix.signal_type == 2:
            assert len(ix.ltp_indices) == 4
            assert ix.lag_index >= 0
        assert 0 <= ix.seed < 4
        assert ix.pulses is not None and abs(ix.pulses).max() <= 1 << 14
        n += 1
    assert n >= 90
    # the content must have produced active frames
    assert types[1] + types[2] > 0


def test_silk_voiced_frames_have_pitch():
    data = _silk_stream("tone")
    rdr = OggReader(_R(data))
    lags = []
    for i, p in enumerate(rdr.packets()):
        if i < 2:
            continue
        toc = parse_toc(p)
        fr = parse_silk_packet(bytes(p[1:]), toc.bandwidth)[0]
        if fr.indices.signal_type == 2:
            lags.append(fr.indices.lag_index)
    assert lags
    # 220 Hz at 16 kHz internal rate -> lag ~73 samples; lagIndex is
    # biased by the minimum lag (2 ms = 32 samples at 16 kHz)
    med = sorted(lags)[len(lags) // 2]
    assert 20 <= med + 32 <= 160


def test_nlsf_decode_to_stable_lpc():
    """NLSF dequantisation + NLSF2A over a whole reference-encoded
    stream: the spacing constraints must hold and every LPC filter must
    be stable (silk/NLSF_decode.c, NLSF_stabilize.c, NLSF2A.c)."""
    from ohpipeline_jax.codecs.opus.silk import (nlsf_decode, nlsf_to_lpc,
                                                 tables)
    data = _silk_stream("tone")
    rdr = OggReader(_R(data))
    T = tables()
    n = 0
    for i, p in enumerate(rdr.packets()):
        if i < 2:
            continue
        toc = parse_toc(p)
        fr = parse_silk_packet(bytes(p[1:]), toc.bandwidth)[0]
        ix = fr.indices
        nlsf = nlsf_decode(toc.bandwidth, ix.nlsf_stage1,
                           ix.nlsf_residuals)
        dmin = T["NLSF_DELTA_MIN_WB_Q15" if toc.bandwidth == "wb"
                 else "NLSF_DELTA_MIN_NB_MB_Q15"]
        assert nlsf[0] >= dmin[0]
        assert all(int(nlsf[k]) - int(nlsf[k - 1]) >= dmin[k]
                   for k in range(1, len(nlsf)))
        assert int(nlsf[-1]) <= (1 << 15) - dmin[len(nlsf)]
        a = nlsf_to_lpc(nlsf)
        roots = np.roots(np.concatenate([[1.0], -a / 4096.0]))
        assert np.abs(roots).max() < 1.0
        n += 1
    assert n >= 90


def test_silk_core_decode_snr():
    """End-to-end SILK-only decode at the internal rate: gains, NLSF,
    LTP, LCG-signed excitation and synthesis filters together must track
    the reference decoder's output (compared against the oracle's 48 kHz
    output band-limited and decimated to the internal rate).  The float
    reformulation is SNR-bounded, not bit-exact."""
    from ohpipeline_jax.codecs.opus.silk import SilkStreamDecoder
    data = _silk_stream("tone")
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "s.opus")
        fo = os.path.join(td, "o.raw")
        open(fin, "wb").write(data)
        subprocess.run([ORACLE, "decode", fin, fo], check=True,
                       capture_output=True)
        ref48 = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    dec = None
    outs = []
    for i, p in enumerate(rdr.packets()):
        if i < 2:
            continue
        toc = parse_toc(p)
        if dec is None:
            dec = SilkStreamDecoder(toc.bandwidth)
        outs.append(dec.decode_frame(bytes(p[1:])))
    mine = np.concatenate(outs).astype(np.float64)
    n = len(ref48) - (len(ref48) % 3)
    X = np.fft.rfft(ref48[:n])
    f = np.fft.rfftfreq(n, 1 / 48000.0)
    X[f > 7600] = 0
    ref = np.fft.irfft(X, n)[::3]
    assert abs(np.sqrt((mine ** 2).mean())
               / max(np.sqrt((ref ** 2).mean()), 1e-9) - 1.0) < 0.05
    best = -1e9
    m = min(len(mine), len(ref))
    for off in range(-400, 200, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 5000:
            continue
        a2, b2 = a[2000:mm - 2000], b[2000:mm - 2000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 18.0, f"SILK decode SNR {best:.1f} dB"


def test_silk_decode_48k_snr():
    """Full-rate decode: core decode at the internal rate plus the
    up2_HQ allpass + 12-phase FIR output resampler must track the
    oracle's 48 kHz output directly (silk/resampler.c decode path)."""
    from ohpipeline_jax.codecs.opus.silk import SilkStreamDecoder
    data = _silk_stream("tone")
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "s.opus")
        fo = os.path.join(td, "o.raw")
        open(fin, "wb").write(data)
        subprocess.run([ORACLE, "decode", fin, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    dec = None
    outs = []
    for i, p in enumerate(rdr.packets()):
        if i < 2:
            continue
        toc = parse_toc(p)
        if dec is None:
            dec = SilkStreamDecoder(toc.bandwidth)
        outs.append(dec.decode_frame_48k(bytes(p[1:])))
    mine = np.concatenate(outs).astype(np.float64)
    # every 20 ms packet must yield exactly 960 samples at 48 kHz
    assert all(len(o) == 960 for o in outs)
    assert abs(np.sqrt((mine ** 2).mean())
               / max(np.sqrt((ref ** 2).mean()), 1e-9) - 1.0) < 0.05
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1200, 600, 1):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 16.0, f"SILK 48 kHz decode SNR {best:.1f} dB"


def test_silk_stream_plays_through_codec():
    """Mono SILK-only Ogg Opus stream through CodecOpus (the playback
    path): correct length/rate bookkeeping (RFC 7845 pre-skip +
    granule trim) and SNR vs the oracle's 48 kHz decode."""
    from ohpipeline_jax.codecs.opus import decode_opus
    data = _silk_stream("tone")
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "s.opus")
        fo = os.path.join(td, "o.raw")
        open(fin, "wb").write(data)
        subprocess.run([ORACLE, "decode", fin, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    info, pcm = decode_opus(data)
    assert info.sample_rate == 48000 and info.num_channels == 1
    mine = pcm[0].astype(np.float64)
    # oracle raw output is not pre-skip/granule-trimmed identically;
    # lengths must agree within one packet
    assert abs(len(mine) - len(ref)) < 2000
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1200, 1200, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 16.0, f"SILK playback SNR {best:.1f} dB"


def _silk_stereo_stream() -> bytes:
    t = np.arange(48000 * 2) / 48000.0
    am = 0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)
    left = np.sin(2 * np.pi * 220 * t) * am * 11000
    right = np.sin(2 * np.pi * 330 * t + 0.7) * am * 9000
    x = np.stack([left, right], axis=1).ravel()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "2", "48000", "silk"],
                       check=True, capture_output=True)
        return open(fout, "rb").read()


def test_silk_stereo_decode_snr():
    """Stereo SILK: mid/side cores in one range coder, predictor
    weights + MS_to_LR reconstruction, per-channel resampling — vs the
    oracle's 48 kHz stereo decode (dec_API.c, stereo_MS_to_LR.c)."""
    from ohpipeline_jax.codecs.opus import decode_opus
    data = _silk_stereo_stream()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "s.opus")
        fo = os.path.join(td, "o.raw")
        open(fin, "wb").write(data)
        subprocess.run([ORACLE, "decode", fin, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).reshape(-1, 2).astype(np.float64)
    # the stream must actually contain stereo-coded SILK packets
    rdr = OggReader(_R(data))
    stereo_pk = sum(1 for i, p in enumerate(rdr.packets())
                    if i >= 2 and parse_toc(p).stereo)
    assert stereo_pk >= 50, f"encoder produced {stereo_pk} stereo packets"
    info, pcm = decode_opus(data)
    assert info.num_channels == 2
    mine = pcm.astype(np.float64)
    for ch in range(2):
        a_full, b_full = ref[:, ch], mine[ch]
        m = min(len(a_full), len(b_full))
        best = -1e9
        for off in range(-1400, 600, 2):
            a = a_full[max(0, off):m + min(0, off)]
            b = b_full[max(0, -off):m - max(0, off)]
            mm = min(len(a), len(b))
            if mm < 20000:
                continue
            a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
            best = max(best, 10 * np.log10(
                (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
        assert best >= 14.0, f"stereo SILK ch{ch} SNR {best:.1f} dB"


def test_silk_60ms_packets_decode():
    """60 ms SILK packets: three 20 ms frames share one range coder
    with conditional coding between them (delta gains, delta pitch,
    no per-frame LTP scale — dec_API.c:322-341, decode_indices.c).
    Compared against the oracle's 48 kHz decode."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    x = np.sin(2 * np.pi * 220 * t) \
        * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "24000",
                        "silk", "60"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    durs = {parse_toc(p).frame_ms for i, p in enumerate(rdr.packets())
            if i >= 2}
    assert 60 in durs, durs
    info, pcm = decode_opus(data)
    mine = pcm[0].astype(np.float64)
    assert abs(len(mine) - len(ref)) < 4000
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1400, 600, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 14.0, f"60 ms SILK SNR {best:.1f} dB"


def test_silk_stereo_60ms_packets_decode():
    """Stereo 60 ms SILK: per-frame stereo predictors + mid-only flags
    interleaved with conditionally-coded mid/side frames (the side
    channel's frame counter equals the mid's, dec_API.c:344-372)."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    am = 0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)
    x = np.stack([np.sin(2 * np.pi * 220 * t) * am * 11000,
                  np.sin(2 * np.pi * 330 * t + 0.7) * am * 9000],
                 axis=1).ravel()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "2", "48000",
                        "silk", "60"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).reshape(-1, 2).astype(np.float64)
    info, pcm = decode_opus(data)
    assert info.num_channels == 2
    for ch in range(2):
        a_full, b_full = ref[:, ch], pcm[ch].astype(np.float64)
        m = min(len(a_full), len(b_full))
        best = -1e9
        for off in range(-1400, 600, 2):
            a = a_full[max(0, off):m + min(0, off)]
            b = b_full[max(0, -off):m - max(0, off)]
            mm = min(len(a), len(b))
            if mm < 20000:
                continue
            a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
            best = max(best, 10 * np.log10(
                (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
        assert best >= 14.0, f"stereo 60 ms ch{ch} SNR {best:.1f} dB"


def _band_snr(ref, mine, lo, hi):
    n = min(len(ref), len(mine))
    n -= n % 2
    R = np.fft.rfft(ref[:n])
    M = np.fft.rfft(mine[:n])
    f = np.fft.rfftfreq(n, 1 / 48000.0)
    sel = (f >= lo) & (f < hi)
    return 10 * np.log10(np.abs(R[sel] ** 2).sum()
                         / max((np.abs(R[sel] - M[sel]) ** 2).sum(), 1e-9))


def test_hybrid_mode_decodes():
    """Hybrid (SWB speech): WB SILK core + CELT bands 17+ in one range
    coder (src/opus_decoder.c:380-612).  The CELT band must be
    near-exact (it's the conformance-tested CELT decoder continuing
    from the SILK-advanced coder at the right bit position with the
    right raw-bit window); the low band carries the SILK float-decode
    tolerance."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    x = np.sin(2 * np.pi * 220 * t) \
        * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 9000 \
        + np.sin(2 * np.pi * 11000 * t) * 2500
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "48000",
                        "hybrid"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    modes = {parse_toc(p).mode for i, p in enumerate(rdr.packets())
             if i >= 2}
    assert modes == {"hybrid"}, modes
    info, pcm = decode_opus(data)
    mine = pcm[0].astype(np.float64)
    m = min(len(ref), len(mine))
    assert _band_snr(ref[:m], mine[:m], 0, 6000) >= 14.0
    assert _band_snr(ref[:m], mine[:m], 10000, 20000) >= 30.0


def test_hybrid_stereo_decodes():
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    am = 0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)
    x = np.stack([np.sin(2 * np.pi * 220 * t) * am * 9000
                  + np.sin(2 * np.pi * 11000 * t) * 2000,
                  np.sin(2 * np.pi * 330 * t + 0.7) * am * 8000
                  + np.sin(2 * np.pi * 12000 * t) * 2000],
                 axis=1).ravel()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "2", "96000",
                        "hybrid"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).reshape(-1, 2).astype(np.float64)
    info, pcm = decode_opus(data)
    assert info.num_channels == 2
    for ch in range(2):
        m = min(len(ref), pcm.shape[1])
        assert _band_snr(ref[:m, ch], pcm[ch, :m].astype(np.float64),
                         0, 6000) >= 10.0, f"ch{ch} low band"
        assert _band_snr(ref[:m, ch], pcm[ch, :m].astype(np.float64),
                         10000, 20000) >= 25.0, f"ch{ch} celt band"


def test_silk_10ms_packets_decode():
    """10 ms SILK frames: 2 subframes, no NLSF interpolation, the
    10 ms pitch contour codebooks (decoder_set_fs.c:58-70,
    decode_pitch.c:45-66)."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    x = np.sin(2 * np.pi * 220 * t) \
        * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "24000",
                        "silk", "10"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    durs = {parse_toc(p).frame_ms for i, p in enumerate(rdr.packets())
            if i >= 2}
    assert durs == {10}, durs
    info, pcm = decode_opus(data)
    mine = pcm[0].astype(np.float64)
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1400, 600, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 13.0, f"10 ms SILK SNR {best:.1f} dB"


@pytest.mark.parametrize("enc_args,want_bw,min_snr", [
    (("1", "6000", "silk"), "nb", 9.0),       # 8 kHz internal rate
    (("1", "20000", "silkmb"), "mb", 14.0),   # 12 kHz internal rate
])
def test_silk_internal_rates(enc_args, want_bw, min_snr):
    """NB and MB SILK streams: 10-order NLSF codebooks, the 8/12 kHz
    pitch-lag tables and low-bits iCDFs, and the 8/12 -> 48 kHz
    resampler increments (silk/decoder_set_fs.c, resampler.c)."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 3) / 48000.0
    x = np.sin(2 * np.pi * 220 * t) \
        * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, *enc_args],
                       check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    bws = {parse_toc(p).bandwidth for i, p in enumerate(rdr.packets())
           if i >= 2}
    assert want_bw in bws, bws
    info, pcm = decode_opus(data)
    mine = pcm[0].astype(np.float64)
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1400, 600, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= min_snr, f"{want_bw} SILK SNR {best:.1f} dB"


def test_mixed_mode_stream_decodes():
    """Auto-mode encoder output switching between modes mid-stream
    (opus_decoder.c handles CELT/SILK/hybrid transitions): the decoder
    must track the oracle across the switch without desync."""
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 4) / 48000.0
    rng = np.random.default_rng(3)
    sp = np.sin(2 * np.pi * 180 * t[:96000]) \
        * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 4 * t[:96000]))) * 9000
    mus = sum(np.sin(2 * np.pi * f * t[96000:] + i) * a
              for i, (f, a) in enumerate(
                  [(220, 4000), (440, 3000), (880, 2500), (1760, 1500),
                   (5000, 1200), (9000, 800)]))
    mus = mus + rng.standard_normal(96000) * 600
    x = np.concatenate([sp, mus])
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "28000"],
                       check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    seq = [parse_toc(p).mode for i, p in enumerate(rdr.packets())
           if i >= 2]
    assert len({*seq}) >= 2, f"encoder produced a single mode: {set(seq)}"
    info, pcm = decode_opus(data)
    mine = pcm[0].astype(np.float64)
    m = min(len(mine), len(ref))
    best = -1e9
    for off in range(-1400, 600, 2):
        a = ref[max(0, off):m + min(0, off)]
        b = mine[max(0, -off):m - max(0, off)]
        mm = min(len(a), len(b))
        if mm < 20000:
            continue
        a2, b2 = a[6000:mm - 6000], b[6000:mm - 6000]
        best = max(best, 10 * np.log10(
            (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)))
    assert best >= 25.0, f"mixed-mode SNR {best:.1f} dB"


def test_silk_stream_plays_through_pipeline(tmp_path):
    """Speech (SILK-only) Ogg Opus through the full pipeline to the
    sink — the reference plays these through the same CodecOpus
    adapter path as music streams."""
    from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    data = _silk_stream("tone")
    path = tmp_path / "speech.opus"
    path.write_bytes(data)
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    mgr = PipelineManager(params)
    chunks = []
    mgr.play_uri(f"file://{path}")
    animator = AnimatorBatch(mgr.pipeline.predriver,
                             lambda s, i: chunks.append((s, i)),
                             use_device=False)
    animator.run()
    mgr.quit()
    assert chunks, "no audio reached the sink"
    info = chunks[0][1]
    assert info.codec_name == "Opus" and info.sample_rate == 48000
    pcm = np.concatenate([c for c, _ in chunks], axis=1)
    x = pcm[0, 20000:68000].astype(np.float64)
    zc = ((x[:-1] < 0) & (x[1:] >= 0)).sum()
    assert abs(zc - 220) <= 14, f"{zc} crossings/s for a 220 Hz tone"


# ---------------------------------------------------------------------------
# Bit-exact conformance of the fixed-point SILK path (silk_core.cc).
# These assert EXACT equality with the reference decoder (opus_decode's
# 48 kHz int16 output) and would fail on the round-2 float reformulation.


def _fix_active() -> bool:
    from ohpipeline_jax.codecs.opus.silk import _have_fix
    return _have_fix()


def _encode_decode_oracle(x: np.ndarray, enc_args: tuple) -> tuple:
    """(ogg_opus_bytes, oracle 48k int16 decode) for int16 input x
    (interleaved if stereo)."""
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        fo = os.path.join(td, "o.raw")
        x.astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, *enc_args],
                       check=True, capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        return data, np.fromfile(fo, np.int16)


@pytest.mark.parametrize("enc_args,channels", [
    (("1", "24000", "silk"), 1),          # WB 20 ms mono
    (("1", "24000", "silk", "60"), 1),    # WB 60 ms (conditional coding)
    (("1", "24000", "silk", "10"), 1),    # WB 10 ms (2 subframes)
    (("1", "6000", "silk"), 1),           # NB (order 10, 8 kHz)
    (("1", "20000", "silkmb"), 1),        # MB (12 kHz resampler)
    (("2", "48000", "silk"), 2),          # stereo mid/side
])
def test_silk_fixed_point_bit_exact(enc_args, channels):
    """The native fixed-point SILK pipeline (decode_core, NLSF2A,
    resampler, stereo unmix — ohpipeline_jax/native/silk_core.cc) must
    reproduce the reference decoder's 48 kHz output bit-for-bit across
    bandwidths, frame sizes and channel modes
    (thirdparty/opus-1.5.2/silk/decode_core.c et al.)."""
    if not _fix_active():
        pytest.skip("native silk core unavailable")
    from ohpipeline_jax.codecs.opus import decode_opus
    t = np.arange(48000 * 2) / 48000.0
    rng = np.random.default_rng(11)
    base = (np.sin(2 * np.pi * 220 * t)
            * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 11000
            + rng.standard_normal(len(t)) * 600)
    if channels == 2:
        r = np.sin(2 * np.pi * 330 * t + 0.7) * 9000
        x = np.stack([base, r], axis=1).ravel()
    else:
        x = base
    data, ref = _encode_decode_oracle(np.clip(x, -32000, 32000), enc_args)
    info, pcm = decode_opus(data)
    assert info.num_channels == channels
    ref = ref.reshape(-1, channels).T
    m = min(pcm.shape[1], ref.shape[1])
    mine = np.rint(pcm[:, :m]).astype(np.int64)
    assert np.array_equal(mine, ref[:, :m].astype(np.int64)), \
        f"max diff {np.abs(mine - ref[:, :m]).max()}"


def test_silk_internal_rate_bit_exact_vs_probe():
    """Internal-rate synthesis (no resampler) vs silk_Decode driven
    directly at the internal rate through tools/silk_probe.c; isolates
    decode_core + parameter dequantisation.  The probe output carries
    the 16->16 kHz copy-resampler delay (12, resampler.c:66) plus the
    one-sample output buffering."""
    if not _fix_active() or not os.path.exists(SILK_PROBE):
        pytest.skip("native silk core or probe unavailable")
    from ohpipeline_jax.codecs.opus.silk import (SilkStreamDecoder,
                                                 parse_silk_packet)
    for kind in ("tone", "pulsed_noise"):
        data = _silk_stream(kind)
        rdr = OggReader(_R(data))
        pkts = [bytes(p[1:]) for i, p in enumerate(rdr.packets())
                if i >= 2]
        ref = _probe_decode(pkts, 16, 1, 16)
        dec = SilkStreamDecoder("wb")
        mine = np.concatenate(
            [dec.synthesise(f.indices) for p in pkts
             for f in parse_silk_packet(p, "wb")])
        sh = 13
        m = min(len(mine), len(ref)) - sh
        assert np.array_equal(mine[:m].astype(np.int64),
                              ref[sh:sh + m].astype(np.int64))


def test_switch_heavy_stream_per_packet_bound():
    """Dedicated RFC 6716 s4.5 conformance: a stream that force-switches
    SILK -> CELT -> hybrid every 8 packets (oracle 'switchy' mode) must
    track opus_decode per packet, including the redundancy-carrying
    switch packets (CELT redundancy frames decode with the packet's
    signalled end band, opus_decoder.c:500-525, and the state resets of
    opus_decoder.c:389/551 apply)."""
    t = np.arange(int(48000 * 4.0)) / 48000.0
    rng = np.random.default_rng(5)
    x = (np.sin(2 * np.pi * 220 * t)
         * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
         + np.sin(2 * np.pi * 1800 * t) * 2000
         + rng.standard_normal(len(t)) * 300)
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "64000",
                        "switchy"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        fo = os.path.join(td, "o.raw")
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    from ohpipeline_jax.codecs.opus import decode_opus
    _info, mine = decode_opus(data)
    mine = mine.astype(np.float64)[0]
    n = min(len(mine), len(ref))
    a, b = mine[:n], ref[:n]
    overall = 10 * np.log10(max((b ** 2).sum(), 1e-9)
                            / max(((a - b) ** 2).sum(), 1e-9))
    assert overall >= 100.0, f"overall {overall:.1f} dB"
    for i in range(n // 960):
        s, e = i * 960, (i + 1) * 960
        snr = 10 * np.log10(max((b[s:e] ** 2).sum(), 1e-9)
                            / max(((a[s:e] - b[s:e]) ** 2).sum(), 1e-9))
        assert snr >= 80.0, f"packet window {i}: {snr:.1f} dB"


def test_silk_mb_10ms_shell_block_roundup():
    """10 ms @ 12 kHz (MB) frames: 120 samples round UP to 8 shell
    blocks (decode_pulses.c:57-61 — the only frame size where
    iter*16 < frame_length); a truncating parser desyncs the range
    decoder and every later symbol.  Conformance: direct-aligned SNR
    vs the reference decoder, like the mode-switch test above."""
    t = np.arange(int(48000 * 2.0)) / 48000.0
    rng = np.random.default_rng(13)
    x = (np.sin(2 * np.pi * 260 * t)
         * (0.5 + 0.4 * np.sin(2 * np.pi * 2 * t)) * 12000
         + rng.standard_normal(len(t)) * 250)
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "1", "20000",
                        "silkmb", "10"], check=True, capture_output=True)
        data = open(fout, "rb").read()
        fo = os.path.join(td, "o.raw")
        subprocess.run([ORACLE, "decode", fout, fo], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).astype(np.float64)
    rdr = OggReader(_R(data))
    tocs = [parse_toc(p) for i, p in enumerate(rdr.packets()) if i >= 2]
    assert {t_.frame_ms for t_ in tocs} == {10}
    assert "mb" in {t_.bandwidth for t_ in tocs}
    from ohpipeline_jax.codecs.opus import decode_opus
    _info, mine = decode_opus(data)
    mine = mine.astype(np.float64)[0]
    n = min(len(mine), len(ref))
    a, b = mine[:n], ref[:n]
    overall = 10 * np.log10(max((b ** 2).sum(), 1e-9)
                            / max(((a - b) ** 2).sum(), 1e-9))
    assert overall >= 90.0, f"MB 10 ms overall {overall:.1f} dB"
