"""HE-AAC (SBR) conformance vs the fdk-aac oracle.

SBR is parametric above the crossover, so exact waveform match is not
defined (ISO/IEC 14496-26 checks HE-AAC with energy criteria); these
tests assert (a) high waveform SNR in the core band, (b) tight per-band
energy-envelope agreement in the SBR band, (c) end-to-end codec
integration (2x output rate).
Reference: OpenHome/Media/Codec/AacFdkBase.cpp over
thirdparty/fdk-aac/libSBRdec.
"""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax.codecs.aac import (CodecAacAdts, _StreamState,
                                       bitstream as BS,
                                       decode_frames_float)
from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
from ohpipeline_jax.codecs.base import EndOfStream, StreamReader

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "aac_oracle")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="aac oracle not built")


def _content(kind: str, secs: float = 2.5) -> np.ndarray:
    t = np.arange(int(44100 * secs)) / 44100.0
    rng = np.random.default_rng(11)
    if kind == "noise":
        x = rng.standard_normal(len(t)) * 4000
    else:
        x = (np.sin(2 * np.pi * 900 * t) * 8000
             * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t))
             + np.sin(2 * np.pi * 6200 * t) * 5000
             + rng.standard_normal(len(t)) * 800)
    return np.clip(x, -32000, 32000).astype(np.int16)


def _encode_he(x: np.ndarray, bitrate: int = 48000):
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        fdec = os.path.join(td, "d.raw")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        str(bitrate), "2", "5"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fdec], check=True,
                       capture_output=True)
        ref = np.fromfile(fdec, np.int16).reshape(-1, 2).T \
            .astype(np.float64)
    return data, ref


class _MemReader(StreamReader):
    def __init__(self, b: bytes):
        self._b = b
        self._p = 0

    def read(self, n):
        out = self._b[self._p:self._p + n]
        self._p += len(out)
        return out

    def peek(self, n):
        return self._b[self._p:self._p + n]

    @property
    def stream_bytes(self):
        return len(self._b)


def _decode_he(data: bytes) -> np.ndarray:
    c = CodecAacAdts()
    rdr = _MemReader(data)
    info = c.stream_initialise(rdr)
    assert info.codec_name == "HE-AAC"
    assert info.sample_rate == 44100          # 22.05k core doubled
    outs = []
    try:
        while True:
            outs.append(c.process(rdr).resolve())
    except EndOfStream:
        pass
    return np.concatenate(outs, axis=1).astype(np.float64), info


def _aligned(ref, got, search=4096):
    n = min(ref.shape[1], got.shape[1])
    best = (-1e18, 0, None, None)
    for off in range(-search, search + 1, 32):
        a = ref[:, max(0, off):n + min(0, off)]
        b = got[:, max(0, -off):n - max(0, off)]
        m = min(a.shape[1], b.shape[1])
        if m < 8192:
            continue
        a2, b2 = a[:, 2048:m - 2048], b[:, 2048:m - 2048]
        s = (a2 * a2).sum() / max(((a2 - b2) ** 2).sum(), 1e-9)
        if s > best[0]:
            best = (s, off, a2, b2)
    return best[2], best[3]


def _band_profiles(a, b, nfft=2048, hop=1024):
    w = np.hanning(nfft)
    f = np.fft.rfftfreq(nfft, 1 / 44100.0)
    edges = 300 * 2 ** (np.arange(0, 19) / 3.0)
    Pa, Pb = [], []
    for i in range(0, a.shape[1] - nfft, hop):
        Pa.append(np.abs(np.fft.rfft(a[:, i:i + nfft] * w, axis=1)) ** 2)
        Pb.append(np.abs(np.fft.rfft(b[:, i:i + nfft] * w, axis=1)) ** 2)
    Pa, Pb = np.asarray(Pa), np.asarray(Pb)
    out_a = np.stack([Pa[..., (f >= edges[i]) & (f < edges[i + 1])]
                      .sum(axis=-1) for i in range(len(edges) - 1)], -1)
    out_b = np.stack([Pb[..., (f >= edges[i]) & (f < edges[i + 1])]
                      .sum(axis=-1) for i in range(len(edges) - 1)], -1)
    return out_a, out_b, edges


@pytest.mark.parametrize("kind,hf_rms_limit", [("noise", 1.0),
                                               ("mix", 0.8)])
def test_he_aac_conformance(kind, hf_rms_limit):
    """Band-energy bounds vs the HQ libSBRdec oracle.  Measured state
    after the fdk-timing/dequant-calibration work: hf rms 0.34 dB on
    noise content, 0.25 dB on mix (was 1.5-6.9 dB before the
    ENERGY_CAL x8 fix) — bounds carry ~2-3x headroom over that."""
    data, ref = _encode_he(_content(kind))
    got, info = _decode_he(data)
    a, b = _aligned(ref, got)
    assert a is not None
    # core-band waveform SNR (below the SBR crossover)
    X = np.fft.rfft(a, axis=1)
    Y = np.fft.rfft(b, axis=1)
    f = np.fft.rfftfreq(a.shape[1], 1 / 44100.0)
    lo = f < 5000
    da = np.fft.irfft(np.where(lo, X, 0), axis=1)
    db = np.fft.irfft(np.where(lo, Y, 0), axis=1)
    snr_low = 10 * np.log10((da ** 2).sum()
                            / max(((da - db) ** 2).sum(), 1e-9))
    assert snr_low >= 40.0, f"core-band SNR {snr_low:.1f} dB"
    # SBR-band energy envelopes
    Pa, Pb, edges = _band_profiles(a, b)
    r = (10 * np.log10((Pb + 1e-3) / (Pa + 1e-3)))[2:-2]
    hf = r[..., edges[:-1] > 6000]
    assert abs(hf.mean()) <= 0.8, f"HF energy bias {hf.mean():.2f} dB"
    rms = float(np.sqrt((hf ** 2).mean()))
    assert rms <= hf_rms_limit, f"HF energy rms {rms:.2f} dB"
    # full-band per-sample SNR: noise filling follows fdk's V-table
    # walk in lock-step, the frame timing is fdk's delayed-output
    # scheme, the chirp levels use the transition-dependent whitening
    # map (lpp_tran.cpp mapInvfMode — LOW is 0.75 steady, 0.6 only on
    # OFF<->LOW transitions) and the VARVAR transient envelope index is
    # fdk's (#borders - pointer).  Measured 37.8 dB noise / 50.5 dB mix
    # after those fixes (was 21.4/41.1 when a flat per-mode chirp table
    # under-whitened every steady LOW band by ~10% patch energy and the
    # off-by-one misplaced noNoiseFlag on VARVAR attack frames).
    err = a - b
    snr = 10 * np.log10((a * a).sum() / max((err * err).sum(), 1e-9))
    assert snr >= (30.0 if kind == "noise" else 42.0), \
        f"per-sample SNR {snr:.1f} dB"


def test_sbr_payloads_parse():
    data, _ref = _encode_he(_content("mix"))
    pos, n, nsbr = 0, 0, 0
    dec = SbrDecoder(22050)
    while pos < len(data):
        h = BS.parse_adts_header(data, pos)
        if h is None:
            break
        br = BS.BitReader(data, (pos + h.header_bytes) * 8)
        fr = BS.parse_raw_data_block(br, h.rate_index)
        n += 1
        if fr.sbr is not None:
            payload, nbits, crc = fr.sbr
            chans, coupling = dec.parse_payload(payload, nbits,
                                                stereo=True, crc=crc)
            assert 1 <= chans[0].grid.n_env <= 5
            assert all(len(r) in (dec.ft.n_high, dec.ft.n_low)
                       for r in chans[0].env)
            nsbr += 1
        pos += h.frame_bytes
    assert n > 20 and nsbr == n


def test_lc_streams_unaffected():
    x = _content("mix")
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "128000"], check=True, capture_output=True)
        data = open(fout, "rb").read()
    c = CodecAacAdts()
    info = c.stream_initialise(_MemReader(data))
    assert info.codec_name == "AAC" and info.sample_rate == 44100


def test_he_aac_tonal_hf():
    """Isolated sinusoid in the SBR band (add_harmonic path): band
    energies must track libSBRdec within bounds."""
    t = np.arange(int(44100 * 2.5)) / 44100.0
    x = np.clip(np.sin(2 * np.pi * 10200 * t) * 7000
                + np.sin(2 * np.pi * 900 * t) * 9000,
                -32000, 32000).astype(np.int16)
    data, ref = _encode_he(x)
    got, _info = _decode_he(data)
    a, b = _aligned(ref, got)
    assert a is not None
    Pa, Pb, edges = _band_profiles(a, b)
    r = (10 * np.log10((Pb + 1e-3) / (Pa + 1e-3)))[2:-2]
    hf = r[..., edges[:-1] > 6000]
    # measured +1.4 mean / 2.6 rms with the calibrated sine injection
    # (a flagged harmonic lands at 0.0 dB of the oracle's band energy;
    # it was -9 dB before INJECT_CAL/ENERGY_CAL)
    assert abs(hf.mean()) <= 2.5
    assert float(np.sqrt((hf ** 2).mean())) <= 4.0
    a2, b2 = _aligned(ref, got)
    err = a2 - b2
    snr = 10 * np.log10((a2 * a2).sum() / max((err * err).sum(), 1e-9))
    assert snr >= 35.0, f"per-sample SNR {snr:.1f} dB"


@pytest.mark.parametrize("explicit", [False, True])
def test_he_aac_in_mp4(explicit):
    """HE-AAC inside an M4A container: implicit (low-rate LC + SBR
    payload probe) and explicit (AOT-5 AudioSpecificConfig hierarchy,
    tpdec_asc.cpp) signalling must both decode — identically to the
    ADTS path, which shares the SBR decoder."""
    from ohpipeline_jax.codecs.aac import (CodecAacMp4, bitstream as BS2,
                                           decode_adts)
    from ohpipeline_jax.codecs.base import BufferReader, EndOfStream
    from ohpipeline_jax.containers.mpeg4 import write_m4a
    data, _ref = _encode_he(_content("mix", secs=1.5))
    frames = []
    pos = 0
    core_rate_idx = None
    while True:
        hdr = BS2.parse_adts_header(data, pos)
        if hdr is None:
            break
        core_rate_idx = hdr.rate_index
        frames.append(data[pos + hdr.header_bytes:pos + hdr.frame_bytes])
        pos += hdr.frame_bytes
    assert core_rate_idx is not None
    if explicit:
        # AOT 5, core rate, stereo, extension rate = 2x, inner AOT 2
        bits = f"00101{core_rate_idx:04b}0010{core_rate_idx - 3:04b}00010000"
        bits += "0" * (-len(bits) % 8)
        asc = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    else:
        bits = f"00010{core_rate_idx:04b}0010000"
        bits += "0" * (-len(bits) % 8)
        asc = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    core_rate = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                 16000, 12000, 11025, 8000][core_rate_idx]
    m4a = write_m4a(frames, asc, core_rate, 2)
    codec = CodecAacMp4()
    r = BufferReader(m4a)
    info = codec.stream_initialise(r)
    assert info.codec_name == "HE-AAC"
    assert info.sample_rate == core_rate * 2
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    out = np.concatenate(parts, axis=1)
    _info_adts, ref = decode_adts(data)
    n = min(out.shape[1], ref.shape[1])
    assert n > 40000
    # <=1 LSB: the ADTS reference path preps spectra vectorized from
    # the native batch (prepare_group) while the MP4 path dequantizes
    # rehydrated frames per frame - summation order moves the int16
    # rounding boundary on isolated samples
    assert np.abs(out[:, :n].astype(np.int64)
                  - ref[:, :n].astype(np.int64)).max() <= 1


def test_he_aac_v2_stereo_reconstruction():
    """HE-AAC v2 (AOT 29, mono core + SBR + PS): the parametric-stereo
    tool reconstructs stereo — per-channel band energies and the
    inter-channel level trajectory must track libSBRdec+PS on panned
    content (psdec.cpp deCorrelate/initSlotBasedRotation)."""
    t = np.arange(int(44100 * 2.5)) / 44100.0
    pan = np.sin(2 * np.pi * 0.9 * t) * 0.5 + 0.5
    base = (np.sin(2 * np.pi * 700 * t) * 9000
            + np.sin(2 * np.pi * 7000 * t) * 3000)
    pcm = np.stack([np.clip(base * pan, -32000, 32000),
                    np.clip(base * (1 - pan), -32000, 32000)])         .astype(np.int16).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        fo = os.path.join(td, "o.raw")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "40000", "2", "29"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fo, "2"], check=True,
                       capture_output=True)
        ref = np.fromfile(fo, np.int16).reshape(-1, 2).T.astype(np.float64)
    rd = _MemReader(data)
    c = CodecAacAdts()
    info = c.stream_initialise(rd)
    assert info.codec_name == "HE-AAC v2"
    assert info.sample_rate == 44100 and info.num_channels == 2
    outs = []
    from ohpipeline_jax.codecs.base import EndOfStream as EOS
    while True:
        try:
            outs.append(c.process(rd).resolve())
        except EOS:
            break
    mine = np.concatenate(outs, axis=1).astype(np.float64)
    m = min(mine.shape[1], ref.shape[1])
    a = ref[:, 2048:m]
    b = mine[:, :m - 2048]          # the PS tool adds one frame delay
    mm = min(a.shape[1], b.shape[1])
    a, b = a[:, 4096:mm - 4096], b[:, 4096:mm - 4096]
    for ch in range(2):
        Pa, Pb, edges = _band_profiles(a[ch:ch + 1], b[ch:ch + 1])
        r = (10 * np.log10((Pb + 1e-3) / (Pa + 1e-3)))[2:-2]
        assert abs(r.mean()) <= 4.0, f"ch{ch} bias {r.mean():.2f}"
        assert float(np.sqrt((r ** 2).mean())) <= 9.0, f"ch{ch}"
    # stereo image: inter-channel level difference per frame
    ea = 10 * np.log10(((a[0] ** 2).reshape(-1, 2048).mean(1) + 1)
                       / ((a[1] ** 2).reshape(-1, 2048).mean(1) + 1))
    eb = 10 * np.log10(((b[0] ** 2).reshape(-1, 2048).mean(1) + 1)
                       / ((b[1] ** 2).reshape(-1, 2048).mean(1) + 1))
    n = min(len(ea), len(eb))
    assert np.corrcoef(ea[:n], eb[:n])[0, 1] >= 0.95
    # fixed-offset comparison (no search): the 6-slot H-delay alignment
    # (see test_he_aac_v2_per_sample_snr) moved the ILD ramp by 384
    # samples within these 2048-sample frames — measured 1.55 here
    # while the optimally-aligned per-sample SNR rose 29.6 -> 32.6 dB;
    # that per-sample bound is the precise gate, this one is coarse
    assert np.sqrt(((ea[:n] - eb[:n]) ** 2).mean()) <= 2.0


def test_ps_payloads_parse():
    """Every PS block of a real HE-AAC v2 stream must parse with
    coherent parameters (psbitdec.cpp ReadPsData: header persistence,
    10/20/34-bin IID/ICC huffman runs, IPD/OPD skip) — hundreds of
    blocks through huffman-coded variable-length data is a strong
    structural check of the symbol schedule."""
    from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
    x = _content("mix", 2.5)
    pcm = np.stack([x, (x * 0.7).astype(np.int16)]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "48000", "2", "29"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
    c = CodecAacAdts()
    info = c.stream_initialise(_MemReader(data))
    assert info.codec_name == "HE-AAC v2"
    # walk the frames, count parsed PS blocks
    from ohpipeline_jax.codecs.aac import bitstream as BS2
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    dec = SbrDecoder(info.sample_rate // 2)
    pos = 0
    n_ps = 0
    while True:
        hdr = BS2.parse_adts_header(data, pos)
        if hdr is None:
            break
        br = BitReader(data, (pos + hdr.header_bytes) * 8)
        try:
            fr = BS2.parse_raw_data_block(br, hdr.rate_index)
        except (BS2.AacError, ValueError, EOFError):
            pos += hdr.frame_bytes
            continue
        if fr.sbr is not None:
            payload, nbits, crc = fr.sbr
            chans, _coup = dec.parse_payload(payload, nbits,
                                             stereo=False, crc=crc)
            ps = chans[0].ps
            if ps is not None:
                n_ps += 1
                assert 0 <= ps.n_env <= 4
                assert ps.mode_iid <= 5 and ps.mode_icc <= 5
                for env in ps.iid_index:
                    assert len(env) in (10, 20, 34)
                    assert all(-30 <= v <= 30 for v in env)
                for env in ps.icc_index:
                    assert len(env) in (10, 20, 34)
                    assert all(-14 <= v <= 14 for v in env)
        pos += hdr.frame_bytes
    assert n_ps >= 50, f"only {n_ps} PS blocks parsed"


def test_ps_index_delta_decode():
    """IID/ICC index delta decoding over a whole v2 stream
    (psbitdec.cpp deltaDecodeArray/DecodePs): absolute indices stay in
    the quantiser ranges across frames and envelopes, the FIX-0-env
    hold path works, and the 34->20 map stays bounded."""
    from ohpipeline_jax.codecs.aac import bitstream as BS2
    from ohpipeline_jax.codecs.aac.sbr import (SbrDecoder,
                                               _ps_map34_to_20,
                                               decode_ps_indices)
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    t = np.arange(int(44100 * 2.5)) / 44100.0
    pan = np.sin(2 * np.pi * 0.9 * t) * 0.5 + 0.5
    base = (np.sin(2 * np.pi * 700 * t) * 9000
            + np.sin(2 * np.pi * 7000 * t) * 3000)
    pcm = np.stack([np.clip(base * pan, -32000, 32000),
                    np.clip(base * (1 - pan), -32000, 32000)]) \
        .astype(np.int16).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "40000", "2", "29"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
    hdr0 = BS2.parse_adts_header(data)
    dec = SbrDecoder(hdr0.sample_rate)
    pos = 0
    prev_iid = prev_icc = None
    frames = iid_active = 0
    while True:
        hdr = BS2.parse_adts_header(data, pos)
        if hdr is None:
            break
        br = BitReader(data, (pos + hdr.header_bytes) * 8)
        fr = BS2.parse_raw_data_block(br, hdr.rate_index)
        if fr.sbr is not None:
            chans, _ = dec.parse_payload(fr.sbr[0], fr.sbr[1],
                                         stereo=False, crc=fr.sbr[2])
            ps = chans[0].ps
            if ps is not None:
                iid, icc, prev_iid, prev_icc = decode_ps_indices(
                    ps, prev_iid, prev_icc)
                steps = 15 if ps.mode_iid > 2 else 7
                for row in iid:
                    assert np.abs(row).max() <= steps
                    if len(row) == 34:
                        assert np.abs(_ps_map34_to_20(row)).max() <= steps
                for row in icc:
                    assert row.min() >= 0 and row.max() <= 7
                if any(np.abs(r).max() > 0 for r in iid):
                    iid_active += 1
                frames += 1
        pos += hdr.frame_bytes
    assert frames >= 40, frames
    # hard-panned content must produce nonzero IIDs
    assert iid_active >= frames // 2


def test_ps_mixing_matrices():
    """Type-A rotation dequant (psdec.cpp): identity at centre,
    total-energy preservation (c_l^2 + c_r^2 = 2) at every IID/ICC
    combination, hard pan kills the opposite channel."""
    from ohpipeline_jax.codecs.aac.sbr import ps_mixing_matrices
    h11, h12, h21, h22 = ps_mixing_matrices([0] * 20, [0] * 20, False)
    assert np.allclose(h11, 1) and np.allclose(h12, 1)
    assert np.allclose(h21, 0) and np.allclose(h22, 0)
    for fine in (False, True):
        steps = 15 if fine else 7
        for iid in range(-steps, steps + 1):
            for icc in range(8):
                h = ps_mixing_matrices([iid] * 20, [icc] * 20, fine)
                e = h[0] ** 2 + h[2] ** 2 + h[1] ** 2 + h[3] ** 2
                assert np.allclose(e, 2.0, atol=1e-5), (iid, icc)
    # hard pan left (positive IID): right direct gain collapses
    h11, h12, h21, h22 = ps_mixing_matrices([7] * 20, [0] * 20, False)
    assert h11[0] > 1.40 and h12[0] < 0.1


def test_ps_hybrid_filterbank_perfect_reconstruction():
    """The PS hybrid analysis/synthesis pair (psdec_hybrid.cpp
    documented 13-tap designs) must reconstruct any QMF signal exactly
    with the 6-slot group delay, including across chunked calls."""
    from ohpipeline_jax.codecs.aac.sbr import PsHybrid
    rng = np.random.default_rng(1)
    X = rng.standard_normal((96, 64)) + 1j * rng.standard_normal((96, 64))
    h = PsHybrid()
    parts = [h.analyze(X[:20]), h.analyze(X[20:50]), h.analyze(X[50:])]
    hyb = np.concatenate([p[0] for p in parts])
    rest = np.concatenate([p[1] for p in parts])
    # 20-band grouping zeroed channels 4/5 into 2/3
    assert np.abs(hyb[:, 4:6]).max() == 0
    Y = PsHybrid.synthesize(hyb, rest)
    assert np.abs(Y[6:] - X[:-6]).max() < 1e-10


def test_he_aac_v2_in_mp4():
    """HE-AAC v2 inside M4A: the AOT-29 AudioSpecificConfig hierarchy
    plus PS detection must produce stereo output identical to the ADTS
    path's."""
    from ohpipeline_jax.codecs.aac import (CodecAacMp4, bitstream as BS2,
                                           decode_adts)
    from ohpipeline_jax.codecs.base import BufferReader, EndOfStream
    from ohpipeline_jax.containers.mpeg4 import write_m4a
    t = np.arange(int(44100 * 1.5)) / 44100.0
    pan = np.sin(2 * np.pi * 0.9 * t) * 0.5 + 0.5
    base = np.sin(2 * np.pi * 700 * t) * 9000
    pcm = np.stack([np.clip(base * pan, -32000, 32000),
                    np.clip(base * (1 - pan), -32000, 32000)]) \
        .astype(np.int16).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "40000", "2", "29"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
    frames = []
    pos = 0
    rate_idx = None
    while True:
        hdr = BS2.parse_adts_header(data, pos)
        if hdr is None:
            break
        rate_idx = hdr.rate_index
        frames.append(data[pos + hdr.header_bytes:pos + hdr.frame_bytes])
        pos += hdr.frame_bytes
    # AOT 29, core rate, mono config, ext rate 2x, inner AOT 2
    bits = f"11101{rate_idx:04b}0001{rate_idx - 3:04b}00010000"
    bits += "0" * (-len(bits) % 8)
    asc = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    core_rate = [96000, 88200, 64000, 48000, 44100, 32000, 24000,
                 22050, 16000, 12000, 11025, 8000][rate_idx]
    m4a = write_m4a(frames, asc, core_rate, 1)
    codec = CodecAacMp4()
    r = BufferReader(m4a)
    info = codec.stream_initialise(r)
    assert info.codec_name == "HE-AAC v2"
    assert info.sample_rate == core_rate * 2 and info.num_channels == 2
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    out = np.concatenate(parts, axis=1)
    _info, ref = decode_adts(data)
    n = min(out.shape[1], ref.shape[1])
    assert n > 40000
    # <=1 LSB: the ADTS reference path preps spectra vectorized from
    # the native batch (prepare_group) while the MP4 path dequantizes
    # rehydrated frames per frame - summation order moves the int16
    # rounding boundary on isolated samples
    assert np.abs(out[:, :n].astype(np.int64)
                  - ref[:, :n].astype(np.int64)).max() <= 1


def test_he_aac_per_sample_snr_tonal():
    """Per-sample SNR vs libSBRdec (VERDICT r2 #6 / r3 #5).  The decoder
    now tracks fdk per sample, not just per band-energy: the HQ
    (complex-QMF) oracle is apples-to-apples (fdk silently used the
    low-power chain for stereo until tools/aac_oracle.c forces HQ), the
    frame scheme is fdk's delayed-output timing so the noise/sine phase
    counters walk fdk's V table in lock-step, and the envelope dequant
    level is calibrated to fdk's own QMF domain (ENERGY_CAL).  Measured:
    50.5 dB on this content after the chirp-transition-map + VARVAR
    tranEnv fixes (was 17.5 when the bound was 14), 71.5 dB pure
    tones."""
    data, ref = _encode_he(_content("mix"))
    got, _info = _decode_he(data)
    a, b = _aligned(ref, got)
    err = a - b
    snr = 10 * np.log10((a * a).sum() / max((err * err).sum(), 1e-9))
    assert snr >= 42.0, f"per-sample SNR {snr:.1f} dB"


def test_he_aac_v2_per_sample_snr():
    """HE-AAC v2 (PS) per-sample SNR vs the HQ oracle (mono cores run
    fdk's HQ chain by default, so this path was always apples-to-apples;
    the delayed-output timing + dequant calibration lifted it too).
    Measured 32.6 dB on mixed content with IPD/OPD ignored on both
    sides (fdk psdec.h:96-98).  The last 3 dB came from the rotation
    timeline: this decoder's hybrid path delays the signal by the
    filter's 6-slot group delay (fdk look-aheads instead,
    psdec_hybrid.cpp:501-504), so the interpolated H matrices must ride
    the same 6-slot delay — applied early, the whole SIDE channel
    (h21*d) decorrelated from the oracle at 13.5 dB; delayed, it
    tracks at 37.7 dB."""
    x = _content("mix")
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        fdec = os.path.join(td, "d.raw")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "24000", "2", "29"], check=True,
                       capture_output=True)
        data = open(fout, "rb").read()
        subprocess.run([ORACLE, "decode", fout, fdec], check=True,
                       capture_output=True)
        ref = np.fromfile(fdec, np.int16).reshape(-1, 2).T \
            .astype(np.float64)
    c = CodecAacAdts()
    r = _MemReader(data)
    info = c.stream_initialise(r)
    assert info.codec_name == "HE-AAC v2"
    outs = []
    try:
        while True:
            outs.append(c.process(r).resolve())
    except EndOfStream:
        pass
    got = np.concatenate(outs, axis=1).astype(np.float64)
    a, b = _aligned(ref, got)
    err = a - b
    snr = 10 * np.log10((a * a).sum() / max((err * err).sum(), 1e-9))
    assert snr >= 30.0, f"v2 per-sample SNR {snr:.1f} dB"
