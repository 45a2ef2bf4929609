"""Hostile-input fuzz for the native ALAC / MP3 / CELT decode paths.

The reference fuzzes and valgrind-checks its decoders on every commit
(SURVEY.md §4; TestCodecInit.cpp:81-82 requires invalid files to be
rejected without crash).  tests/test_native_hardening.py already pins
shared failure semantics for the SILK packet parser, the Vorbis
residue walk and (in test_aac_native_sbr.py) the SBR payload parser;
this file extends the same contract to the remaining native cores:

* alac_core.cc   — attacker-controlled ALAC packets (random bytes and
  bit-flipped oracle packets) must terminate and agree with the pure-
  Python loops on every outcome: same exception kind or identical PCM.
* mp3_core.cc    — bit-flipped MP3 streams through mp3_parse_huffman
  must agree sample-for-sample with the Python Huffman walk (side
  info/scalefactor parsing is shared code, so any divergence isolates
  the native Huffman core).
* celt_core.cc   — corrupted CELT packets through the native entropy
  layer (header → energies → allocation → PVQ → anti-collapse) must
  agree with the Python behaviour oracle per packet: same exception
  kind, or int16-identical PCM (float ulp differences are quantized
  away exactly as CodecOpus does).
"""

import os
import pathlib
import struct
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native

ORACLES = pathlib.Path(__file__).resolve().parent.parent / ".oracle_build"


# --------------------------------------------------------------------------
# ALAC


def _alac_cfg_and_packets(seconds: float = 0.6):
    from ohpipeline_jax.codecs import alac as AL
    oracle = ORACLES / "alac_oracle"
    if not oracle.exists():
        pytest.skip("alac oracle unavailable")
    rng = np.random.default_rng(21)
    n = int(44100 * seconds)
    t = np.arange(n) / 44100.0
    x = np.clip(np.stack([
        np.sin(2 * np.pi * 500 * t) * 11000
        + rng.standard_normal(n) * 800,
        np.sin(2 * np.pi * 700 * t) * 8000]), -32000, 32000) \
        .astype(np.int16)
    with tempfile.TemporaryDirectory() as td:
        fin = pathlib.Path(td) / "i.raw"
        fout = pathlib.Path(td) / "o.alac"
        np.ascontiguousarray(x.T).tofile(fin)
        subprocess.run([str(oracle), "encode", str(fin), str(fout),
                        "44100", "2"], check=True, capture_output=True)
        raw = fout.read_bytes()
    clen = struct.unpack("<I", raw[:4])[0]
    cfg = AL.AlacConfig.parse(raw[4:4 + clen])
    p = 4 + clen
    npk = struct.unpack("<I", raw[p:p + 4])[0]
    p += 4
    pkts = []
    for _ in range(npk):
        sz = struct.unpack("<I", raw[p:p + 4])[0]
        p += 4
        pkts.append(raw[p:p + sz])
        p += sz
    return cfg, pkts


def _alac_decode_both(pk: bytes, cfg, monkeypatch):
    """(kind, pcm) through the native path and the pure-Python path."""
    from ohpipeline_jax.codecs import alac as AL
    outs = []
    for force_py in (False, True):
        if force_py:
            monkeypatch.setattr(native, "have_alac_core", lambda: False)
        try:
            outs.append(("ok", AL.decode_packet(pk, cfg)))
        except Exception as e:              # noqa: BLE001 — kinds compared
            outs.append((type(e).__name__, None))
        if force_py:
            monkeypatch.undo()
    return outs


@pytest.mark.skipif(not native.have_alac_core(),
                    reason="native alac core unavailable")
def test_alac_survives_hostile_packets(monkeypatch):
    """Random-byte ALAC packets: bounded termination, shared failure
    semantics between alac_core.cc and the Python loops."""
    cfg, _ = _alac_cfg_and_packets(0.2)
    rng = np.random.default_rng(77)
    decoded = 0
    for trial in range(150):
        n = int(rng.integers(1, 160))
        pk = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        (ka, ra), (kb, rb) = _alac_decode_both(pk, cfg, monkeypatch)
        assert ka == kb, (trial, ka, kb)
        if ka == "ok":
            assert ra[1] == rb[1]
            np.testing.assert_array_equal(ra[0], rb[0])
            decoded += 1
    # random bytes rarely form a full packet; the agreement is the point


@pytest.mark.skipif(not native.have_alac_core(),
                    reason="native alac core unavailable")
def test_alac_survives_bitflips(monkeypatch):
    """Single-bit corruptions of real oracle packets: every outcome
    (accept with identical PCM, or same exception kind) must agree."""
    cfg, pkts = _alac_cfg_and_packets(0.6)
    rng = np.random.default_rng(78)
    oks = fails = 0
    for trial in range(120):
        pk = bytearray(pkts[int(rng.integers(0, len(pkts)))])
        pk[int(rng.integers(0, len(pk)))] ^= 1 << int(rng.integers(0, 8))
        (ka, ra), (kb, rb) = _alac_decode_both(bytes(pk), cfg, monkeypatch)
        assert ka == kb, (trial, ka, kb)
        if ka == "ok":
            assert ra[1] == rb[1]
            np.testing.assert_array_equal(ra[0], rb[0])
            oks += 1
        else:
            fails += 1
    assert oks > 0          # the fuzz must exercise the accept path too


# --------------------------------------------------------------------------
# MP3


def _mp3_walk(data: bytes):
    """All parsed frames' Huffman spectra through Mp3Stream (the exact
    layer mp3_core.cc implements; header/side-info/resync are shared
    Python either way, and no jit is entered — ASAN-safe)."""
    from ohpipeline_jax.codecs.mp3.bitstream import Mp3Stream
    st = Mp3Stream(data)
    out = []
    while True:
        try:
            fr = st.next_frame()
        except Exception as e:              # noqa: BLE001 — kinds compared
            out.append(("raise", type(e).__name__))
            return out
        if fr is None:
            return out
        if fr.side is None:
            out.append(("skip", None))
            continue
        for gr in fr.side.granules:
            for g in gr:
                out.append(("g", g.spectrum.copy()))


@pytest.mark.skipif(not native.have_mp3_core(),
                    reason="native mp3 core unavailable")
def test_mp3_huffman_survives_bitflips(monkeypatch):
    """Bit-flipped MP3 streams: the native Huffman walk and the Python
    fallback must agree granule-for-granule on the decoded spectra (or
    skip/fail identically) — header/side-info parsing and resync are
    shared code, so the diff surface is exactly mp3_parse_huffman."""
    from ohpipeline_jax.codecs.mp3 import encoder as ENC
    rng = np.random.default_rng(55)
    spec = np.zeros((2, 576), np.int32)
    m = rng.random((2, 576)) < 0.3
    spec[m] = rng.integers(1, 13, m.sum())
    base = bytearray(ENC.build_stream([spec[0], spec[1]], nframes=10))
    for trial in range(80):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(0, len(data)))] ^= \
                1 << int(rng.integers(0, 8))
        data = bytes(data)
        nat = _mp3_walk(data)
        monkeypatch.setattr(native, "have_mp3_core", lambda: False)
        py = _mp3_walk(data)
        monkeypatch.undo()
        assert len(nat) == len(py), trial
        for i, ((ta, va), (tb, vb)) in enumerate(zip(nat, py)):
            assert ta == tb, (trial, i, ta, tb)
            if ta == "g":
                np.testing.assert_array_equal(va, vb,
                                              err_msg=f"{trial}:{i}")
            elif ta == "raise":
                assert va == vb, (trial, i, va, vb)


# --------------------------------------------------------------------------
# CELT


def _opus_encode(pcm: np.ndarray, mode: str, bitrate: int) -> bytes:
    oracle = ORACLES / "opus_oracle"
    if not oracle.exists():
        pytest.skip("opus oracle unavailable")
    ch = pcm.shape[0]
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([str(oracle), "encode", fin, fout, str(ch),
                        str(bitrate), mode], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _q16(pcm: np.ndarray) -> np.ndarray:
    """CodecOpus's float → int16 quantization (codecs/opus:551)."""
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int32)


@pytest.mark.skipif(not native.have_celt_core(),
                    reason="native celt core unavailable")
def test_celt_survives_hostile_packets():
    """Corrupted CELT packets through two independent decode states —
    native entropy core vs the Python behaviour oracle — must agree per
    packet: same exception kind, or int16-identical PCM.  States are
    re-created after any rejected packet (post-failure decoder state is
    not part of the shared contract)."""
    from ohpipeline_jax.codecs.base import BufferReader
    from ohpipeline_jax.codecs.opus import _OpusStream
    from ohpipeline_jax.codecs.opus_headers import parse_opus_head
    from ohpipeline_jax.containers.ogg import OggReader

    rate = 48000
    t = np.arange(int(rate * 0.6)) / rate
    rng = np.random.default_rng(9)
    x = np.clip(np.sin(2 * np.pi * 440 * t) * 9000
                + np.sin(2 * np.pi * 3100 * t) * 2000
                + rng.standard_normal(len(t)) * 600, -32000, 32000)
    pcm = np.stack([x, np.roll(x, 13)]).astype(np.int16)
    data = _opus_encode(pcm, "celt", 96000)

    packets = list(OggReader(BufferReader(data)).packets())
    head = parse_opus_head(packets[0])
    audio = [p for p in packets[2:] if p]
    assert audio

    def decode(st, pk, force_py):
        if force_py:
            os.environ["OHP_CELT_PY"] = "1"
        try:
            return ("ok", _q16(st.decode_packet(pk)))
        except Exception as e:              # noqa: BLE001 — kinds compared
            return (type(e).__name__, None)
        finally:
            os.environ.pop("OHP_CELT_PY", None)

    st_nat, st_py = _OpusStream(head), _OpusStream(head)
    oks = fails = 0
    for trial in range(120):
        src = audio[trial % len(audio)]
        variant = trial % 3
        if variant == 0:
            pk = src                                  # pristine
        elif variant == 1:
            b = bytearray(src)                        # flip past the TOC
            if len(b) > 1:
                b[1 + int(rng.integers(0, len(b) - 1))] ^= \
                    1 << int(rng.integers(0, 8))
            pk = bytes(b)
        else:                                         # random payload
            n = int(rng.integers(1, 90))
            pk = src[:1] + bytes(rng.integers(0, 256, n, dtype=np.uint8))
        (ka, ra) = decode(st_nat, pk, False)
        (kb, rb) = decode(st_py, pk, True)
        assert ka == kb, (trial, ka, kb)
        if ka == "ok":
            np.testing.assert_array_equal(ra, rb, err_msg=str(trial))
            oks += 1
        else:
            fails += 1
            st_nat, st_py = _OpusStream(head), _OpusStream(head)
    assert oks > 0


# --------------------------------------------------------------------------
# Batched group parsers (the serving/bench wire producers)


@pytest.mark.skipif(not native.have_flac_unpack(),
                    reason="native flac unpacker unavailable")
def test_flac_group_parsers_survive_corruption():
    """flac_parse_group / group16 / group_zz / group_rice consume
    untrusted FLAC streams in the serving APIs.  Random buffers and
    bit-flipped real streams must terminate with bounded outputs:
    0 <= n <= max_frames, the bit cursor inside the buffer, per-frame
    blocksizes within streaminfo's bound.  Run under OHP_NATIVE_ASAN=1
    + LD_PRELOAD=libasan for the memory-safety half of the contract."""
    from ohpipeline_jax.codecs.flac import frames as FF
    from ohpipeline_jax.codecs.flac.encoder import encode_flac

    rng = np.random.default_rng(31)
    n = 4096 * 6
    t = np.arange(n) / 44100.0
    x = np.clip(np.sin(2 * np.pi * 480 * t) * 14000
                + rng.standard_normal(n) * 1200, -30000, 30000)
    pcm = np.stack([x, np.roll(x, 9)]).astype(np.int32)
    data = encode_flac(pcm, 44100, 16)
    meta = FF.parse_metadata(data)
    si = meta.streaminfo
    bit0 = meta.header_bytes * 8
    MF, stride = 4, si.max_blocksize
    B = MF * si.channels
    kw = dict(sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
              max_blocksize=stride, channels=si.channels, max_frames=MF)

    def check(res, buf, crc):
        nfr, pos = res[0], res[1]
        assert 0 <= nfr <= MF
        assert 0 <= pos <= len(buf) * 8
        bs = res[3]["blocksize"]
        assert (bs[:nfr] >= 1).all() and (bs[:nfr] <= stride).all()
        assert (res[3]["order"] <= 32).all()
        return nfr

    def all_parsers(buf, crc):
        check(native.flac_parse_group(buf, bit0, check_crc16=crc, **kw),
              buf, crc)
        out16 = np.zeros((B, stride), np.int16)
        scr = np.zeros((B, stride), np.int32)
        check(native.flac_parse_group16(buf, bit0, out16, scr,
                                        check_crc16=crc, **kw), buf, crc)
        lo = np.zeros((B, stride), np.uint8)
        hi = np.zeros((B, stride // 2), np.uint8)
        warm = np.zeros((B, 32), np.int32)
        check(native.flac_parse_group_zz(buf, bit0, lo, hi, warm, scr,
                                         native.EscapeList(1024), 0,
                                         check_crc16=crc, **kw), buf, crc)
        gcur = np.zeros((B, stride // 64), np.int32)
        gk = np.zeros((B, stride // 64), np.int8)
        return check(native.flac_parse_group_rice(
            buf, bit0, gcur, gk, warm, scr, native.RiceOverflow(1024),
            native.RiceConstFill(256), native.EscapeList(1024), 0,
            check_crc16=crc, **kw), buf, crc)

    assert all_parsers(data, True) > 0       # pristine stream parses
    for trial in range(50):
        buf = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            buf[int(rng.integers(bit0 // 8, len(buf)))] ^= \
                1 << int(rng.integers(0, 8))
        # crc-off forces the parser deep into corrupted subframe payloads
        all_parsers(bytes(buf), trial % 2 == 0)
    for trial in range(50):
        junk = data[:meta.header_bytes] + bytes(
            rng.integers(0, 256, int(rng.integers(1, 6000)), dtype=np.uint8))
        all_parsers(junk, trial % 2 == 0)


@pytest.mark.skipif(not native.have_aac_unpack(),
                    reason="native aac unpacker unavailable")
def test_aac_group_parsers_survive_corruption():
    """aac_parse_group / _sbr on bit-flipped and random ADTS buffers
    (the checked-in dryrun assets are real fdk-encoded streams):
    bounded outputs, byte cursor inside the buffer, no crash — also a
    misdeclared channel count must not crash the batch layout."""
    here = pathlib.Path(__file__).resolve().parent
    rng = np.random.default_rng(32)
    for name, ch in (("dryrun.aac", 2), ("dryrun_he.aac", 2)):
        data = (here / "assets" / name).read_bytes()

        def run(buf, channels):
            nfr, pos, _b = native.aac_parse_group(
                buf, 0, channels=channels, max_frames=4)
            assert 0 <= nfr <= 4 and 0 <= pos <= len(buf)
            r = native.aac_parse_group_sbr(
                buf, 0, channels=channels, max_frames=4)
            assert 0 <= r[0] <= 4 and 0 <= r[1] <= len(buf)
            return nfr

        assert run(data, ch) > 0
        run(data, 1)                         # misdeclared channel count
        for trial in range(60):
            buf = bytearray(data[:8192])
            for _ in range(int(rng.integers(1, 6))):
                buf[int(rng.integers(0, len(buf)))] ^= \
                    1 << int(rng.integers(0, 8))
            run(bytes(buf), ch)
        for trial in range(40):
            junk = bytes(rng.integers(0, 256,
                                      int(rng.integers(1, 4000)),
                                      dtype=np.uint8))
            run(junk, ch)
