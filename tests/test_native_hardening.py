"""Crafted/corrupt-stream hardening for the native unpackers.

The reference survives hostile network bitstreams (its decoders are fuzzed
and valgrind-checked on every commit, SURVEY.md §4); these tests pin the
equivalent guarantees for the C unpackers:

* AAC: an ADTS frame coding max_sfb beyond the SFB table for its rate
  (aac_unpack.cc parse_ics_stream) must be rejected, not decoded with
  garbage band widths (previously an OOB heap write).
* FLAC: an LPC/fixed subframe whose predictor order exceeds the frame
  blocksize (possible when STREAMINFO claims max_blocksize < 32) must be
  rejected before warm-up samples are written (previously overflowed the
  caller's row buffer).  Likewise wasted-bits >= bps (shift-count UB).
"""

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs.flac.bitreader import BitWriter, crc8, crc16


pytestmark = pytest.mark.skipif(
    not (native.have_flac_unpack() and native.have_aac_unpack()),
    reason="native unpackers unavailable")


def _flac_frame(blocksize: int, subframe_bits) -> bytes:
    """One mono 16-bit FLAC frame with caller-supplied subframe payload."""
    bw = BitWriter()
    bw.write(0x3FFE, 14)
    bw.write(0, 1)
    bw.write(0, 1)                      # fixed-blocksize stream
    bw.write(6, 4)                      # 8-bit blocksize-1 follows
    bw.write(0, 4)                      # rate from STREAMINFO
    bw.write(0, 4)                      # mono
    bw.write(4, 3)                      # 16-bit
    bw.write(0, 1)
    bw.write_utf8_coded(0)              # frame number 0
    bw.write(blocksize - 1, 8)
    hdr = bytes(bw._out)
    bw.write(crc8(hdr), 8)
    subframe_bits(bw)
    bw.align_byte()
    frame = bw.getvalue()
    import struct
    return frame + struct.pack(">H", crc16(frame))


def test_flac_rejects_order_above_blocksize():
    # LPC order 32 inside a 16-sample frame: the 32 warm-up samples would
    # overflow the (max_frames*channels, 16) int32 row buffer.
    def sub(bw):
        bw.write(0, 1)
        bw.write(32 + 31, 6)            # LPC, order 32
        bw.write(0, 1)                  # no wasted bits
        for _ in range(32):             # warm-up
            bw.write_signed(1, 16)
        bw.write(13, 4)                 # precision-1
        bw.write_signed(2, 5)
        for _ in range(32):
            bw.write_signed(1, 14)
        bw.write(0, 2)                  # residual method 0
        bw.write(0, 4)                  # porder 0
        bw.write(0, 4)                  # rice param 0 (no residuals fit)

    buf = _flac_frame(16, sub)
    n, _, _, batch = native.flac_parse_group(
        buf, 0, sample_rate=44100, bits_per_sample=16, max_blocksize=16,
        channels=1, max_frames=1)
    assert n == 0
    assert not batch["data"].any()      # warm-up must not have been written


def test_flac_rejects_wasted_bits_eating_all_bps():
    # wasted >= bps leaves read_signed(<=0) — undefined shift before fix.
    def sub(bw):
        bw.write(0, 1)
        bw.write(1, 6)                  # VERBATIM
        bw.write(1, 1)                  # wasted-bits flag
        bw.write_unary(16)              # wasted = 17 > bps 16
        for _ in range(16):
            bw.write(0, 8)

    buf = _flac_frame(16, sub)
    n, _, _, _ = native.flac_parse_group(
        buf, 0, sample_rate=44100, bits_per_sample=16, max_blocksize=16,
        channels=1, max_frames=1)
    assert n == 0


class _AdtsWriter:
    def __init__(self):
        self.bits = []

    def write(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def payload(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8))


def _adts(payload: bytes, rate_index: int = 4) -> bytes:
    frame_len = 7 + len(payload)
    hdr = bytearray(7)
    hdr[0] = 0xFF
    hdr[1] = 0xF1                        # MPEG-4, no CRC
    hdr[2] = (1 << 6) | (rate_index << 2)  # AAC-LC profile
    hdr[2] |= 0                          # channel cfg high bit
    hdr[3] = (2 << 6) | ((frame_len >> 11) & 0x3)
    hdr[4] = (frame_len >> 3) & 0xFF
    hdr[5] = ((frame_len & 0x7) << 5) | 0x1F
    hdr[6] = 0xFC
    return bytes(hdr) + payload


def test_aac_rejects_max_sfb_beyond_rate_table():
    # Long-window SCE with max_sfb=63: 44.1 kHz has far fewer long SFBs;
    # band widths read past the table end and previously drove OOB writes.
    w = _AdtsWriter()
    w.write(0, 3)                        # SCE
    w.write(0, 4)                        # instance tag
    w.write(100, 8)                      # global gain
    w.write(0, 1)                        # ics_reserved
    w.write(0, 2)                        # long window
    w.write(0, 1)                        # shape
    w.write(63, 6)                       # max_sfb (bogus)
    w.write(0, 1)                        # no prediction
    # section data: claim everything codebook 1 so decode proceeds
    w.write(1, 4)
    w.write(31, 5)
    w.write(1, 4)
    w.write(31, 5)
    w.write(1, 4)
    w.write(1, 5)
    w.write(7, 3)                        # END
    buf = _adts(w.payload())
    n, pos, batch = native.aac_parse_group(buf, 0, channels=1, max_frames=1)
    assert n == 0
    assert not batch["quant"].any()


def test_aac_rejects_cpe_shared_max_sfb():
    # CPE with common_window and bogus shared max_sfb: the M/S mask loop
    # previously wrote SFB_SLOTS bytes from a 63-entry iteration.
    w = _AdtsWriter()
    w.write(1, 3)                        # CPE
    w.write(0, 4)
    w.write(1, 1)                        # common window
    w.write(0, 1)                        # ics_reserved
    w.write(0, 2)
    w.write(0, 1)
    w.write(63, 6)                       # shared max_sfb (bogus)
    w.write(0, 1)
    w.write(1, 2)                        # ms_present = 1 (per-band mask)
    for _ in range(63):
        w.write(1, 1)
    w.write(7, 3)
    buf = _adts(w.payload())
    n, pos, batch = native.aac_parse_group(buf, 0, channels=2, max_frames=1)
    assert n == 0


def test_alac_python_fallback_matches_native(monkeypatch):
    """The pure-Python ALAC loops and the C++ core must agree
    bit-for-bit (the fallback is the documented behaviour without a
    toolchain)."""
    import pathlib
    import numpy as np
    from ohpipeline_jax import native
    from ohpipeline_jax.codecs import alac as AL
    ORACLE = pathlib.Path(__file__).resolve().parent.parent \
        / ".oracle_build" / "alac_oracle"
    if not ORACLE.exists() or not native.have_alac_core():
        import pytest
        pytest.skip("oracle or native alac core unavailable")
    import struct
    import subprocess
    import tempfile
    rng = np.random.default_rng(4)
    t = np.arange(44100) / 44100.0
    x = np.clip(np.stack([
        np.sin(2 * np.pi * 400 * t) * 12000
        + rng.standard_normal(len(t)) * 900,
        np.sin(2 * np.pi * 620 * t) * 9000]), -32000, 32000) \
        .astype(np.int16)
    with tempfile.TemporaryDirectory() as td:
        fin = pathlib.Path(td) / "i.raw"
        fout = pathlib.Path(td) / "o.alac"
        np.ascontiguousarray(x.T).tofile(fin)
        subprocess.run([str(ORACLE), "encode", str(fin), str(fout),
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
    native_out = [AL.decode_packet(pk, cfg) for pk in pkts[:8]]
    monkeypatch.setattr(native, "have_alac_core", lambda: False)
    python_out = [AL.decode_packet(pk, cfg) for pk in pkts[:8]]
    for (pa, na), (pb, nb) in zip(native_out, python_out):
        assert na == nb
        np.testing.assert_array_equal(pa, pb)


def test_mp3_python_fallback_matches_native(monkeypatch):
    """Pure-Python MP3 Huffman decode agrees with the C++ core."""
    import numpy as np
    from ohpipeline_jax import native
    if not native.have_mp3_core():
        import pytest
        pytest.skip("native mp3 core unavailable")
    from ohpipeline_jax.codecs.mp3 import decode_mp3
    from ohpipeline_jax.codecs.mp3 import encoder as ENC
    rng = np.random.default_rng(6)
    spec = np.zeros((2, 576), np.int32)
    m = rng.random((2, 576)) < 0.3
    spec[m] = rng.integers(1, 13, m.sum())
    data = ENC.build_stream([spec[0], spec[1]], nframes=12)
    _info, a = decode_mp3(data)
    monkeypatch.setattr(native, "have_mp3_core", lambda: False)
    _info, b = decode_mp3(data)
    np.testing.assert_array_equal(a, b)


def test_vorbis_python_fallback_matches_native(monkeypatch):
    """The pure-Python residue walk (codecs/vorbis/residue.py) and the
    native vorbis_core.cc must agree bit-for-bit on decoded PCM,
    including the partial-spectrum end-of-packet path."""
    import numpy as np
    import pytest
    from ohpipeline_jax import native
    from ohpipeline_jax.codecs.vorbis import decode_vorbis
    from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
    if not native.have_vorbis_core():
        pytest.skip("native vorbis core unavailable")
    rng = np.random.default_rng(11)
    spec = StreamSpec(channels=2, sample_rate=44100, bs0=256, bs1=1024,
                      coupling=True)
    blocks = []
    for i in range(40):
        flag = int(i % 5 != 0)
        half = 512 if flag else 128
        r = np.zeros((2, half), np.int64)
        m = rng.random((2, half)) < 0.35
        r[m] = rng.integers(-2, 3, m.sum())
        blocks.append((flag, [(140, 120)] * 2, r))
    data = spec.build(blocks)
    _, native_pcm = decode_vorbis(data)
    monkeypatch.setenv("OHP_VORBIS_PY", "1")
    _, py_pcm = decode_vorbis(data)
    assert np.array_equal(native_pcm, py_pcm)
    assert native_pcm.shape[1] > 0


def test_silk_parse_survives_random_bytes():
    """The native SILK packet parser consumes attacker-controlled
    bytes; random garbage must terminate (all symbol loops are
    bounded: shell recursion depth 4, LSB shifts capped at 10, shell
    blocks <= 20) and must agree with the Python parse on every parsed
    field — the two paths share failure semantics, not just success
    semantics."""
    import os
    if not native.have_silk_core():
        pytest.skip("native silk core unavailable")
    from ohpipeline_jax.codecs.opus import silk as S
    rng = np.random.default_rng(99)
    for trial in range(40):
        n = int(rng.integers(1, 200))
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for stereo in (False, True):
            for dur in (10, 20, 40, 60):
                bw = ("nb", "mb", "wb")[trial % 3]
                if stereo:
                    nat = S.parse_silk_packet_stereo(data, bw, dur)
                    os.environ["OHP_SILK_PY"] = "1"
                    try:
                        py = S._parse_silk_packet_stereo_py(data, bw, dur)
                    finally:
                        del os.environ["OHP_SILK_PY"]
                    assert len(nat) == len(py)
                    for (fm_a, fs_a, pred_a, mo_a), \
                            (fm_b, fs_b, pred_b, mo_b) in zip(nat, py):
                        assert pred_a == pred_b and mo_a == mo_b
                        np.testing.assert_array_equal(
                            np.asarray(fm_a.indices.pulses, np.int64),
                            np.asarray(fm_b.indices.pulses, np.int64))
                        assert (fs_a is None) == (fs_b is None)
                else:
                    nat = S.parse_silk_packet(data, bw, duration_ms=dur)
                    os.environ["OHP_SILK_PY"] = "1"
                    try:
                        py = S._parse_silk_packet_py(data, bw, dur)
                    finally:
                        del os.environ["OHP_SILK_PY"]
                    assert len(nat) == len(py)
                    for a, b in zip(nat, py):
                        assert a.indices.gain_indices \
                            == b.indices.gain_indices
                        np.testing.assert_array_equal(
                            np.asarray(a.indices.pulses, np.int64),
                            np.asarray(b.indices.pulses, np.int64))


def test_vorbis_residue_survives_random_packets(monkeypatch):
    """Hostile audio packets through the native residue/codebook walk
    (vorbis_core.cc): bounded termination and result-exact agreement
    with the pure-Python fallback — shared FAILURE semantics (same
    reject/partial-spectrum behaviour), not just success semantics."""
    import numpy as np
    import pytest
    from ohpipeline_jax import native
    from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
    from ohpipeline_jax.codecs.vorbis.headers import (parse_identification,
                                                      parse_setup)
    from ohpipeline_jax.codecs.vorbis.synthesis import PacketDecoder
    if not native.have_vorbis_core():
        pytest.skip("native vorbis core unavailable")
    spec = StreamSpec(channels=2, sample_rate=44100, bs0=256, bs1=1024,
                      coupling=True)
    info = parse_identification(spec.id_packet())
    setup = parse_setup(spec.setup_packet(), info.channels)
    dec_nat = PacketDecoder(info, setup)
    assert dec_nat._native is not None
    monkeypatch.setenv("OHP_VORBIS_PY", "1")
    dec_py = PacketDecoder(info, setup)
    assert dec_py._native is None
    rng = np.random.default_rng(4242)
    decoded = 0
    for trial in range(300):
        n = int(rng.integers(1, 120))
        pkt = bytearray(rng.integers(0, 256, n, dtype=np.uint8))
        if trial % 2:
            pkt[0] &= 0xFE              # force the audio-packet bit
        pkt = bytes(pkt)
        outs = []
        for dec in (dec_nat, dec_py):
            try:
                outs.append(("ok", dec.decode_spectrum(pkt)))
            except Exception as e:      # noqa: BLE001 — kinds compared
                outs.append((type(e).__name__, None))
        (ka, ra), (kb, rb) = outs
        assert ka == kb, (trial, ka, kb)
        if ka == "ok" and ra is not None:
            assert rb is not None, trial
            assert ra[:3] == rb[:3], trial
            np.testing.assert_array_equal(ra[3], rb[3])
            decoded += 1
        elif ka == "ok":
            assert rb is None, trial
    assert decoded > 10                 # the comparison actually bites
