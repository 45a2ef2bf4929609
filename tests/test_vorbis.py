"""Vorbis conformance: real-world Ogg file cross-validated against the
reference's Tremor oracle, plus spec-vector unit tests."""

import pathlib
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs.vorbis import CodecVorbis, decode_vorbis
from ohpipeline_jax.codecs.vorbis.bitreader import (LsbBitReader,
                                                    float32_unpack, ilog,
                                                    lookup1_values)
from ohpipeline_jax.codecs.vorbis.codebook import assign_codewords

ORACLE = pathlib.Path(__file__).resolve().parent.parent / \
    ".oracle_build" / "vorbis_oracle"
REAL_OGG = pathlib.Path(
    "/opt/venv/lib/python3.12/site-packages/pygame/examples/data/"
    "house_lo.ogg")


class TestBitPrimitives:
    def test_lsb_reader(self):
        br = LsbBitReader(bytes([0b10110001, 0b11101101]))
        assert br.read(4) == 0b0001
        assert br.read(4) == 0b1011
        assert br.read(3) == 0b101
        assert br.read(5) == 0b11101

    def test_ilog(self):
        assert [ilog(x) for x in (0, 1, 2, 3, 4, 7)] == [0, 1, 2, 2, 3, 3]

    def test_float32_unpack(self):
        # 1.0 = mantissa 1, exponent 788
        assert float32_unpack((788 << 21) | 1) == 1.0
        assert float32_unpack((788 << 21) | 1 | (1 << 31)) == -1.0

    def test_lookup1(self):
        assert lookup1_values(9, 2) == 3
        assert lookup1_values(8, 2) == 2
        assert lookup1_values(1, 1) == 1

    def test_canonical_codewords(self):
        # spec §3.2.1 worked example
        codes = assign_codewords([2, 4, 4, 4, 4, 2, 3, 3])
        assert codes == {0: 0b00, 1: 0b0100, 2: 0b0101, 3: 0b0110,
                         4: 0b0111, 5: 0b10, 6: 0b110, 7: 0b111}


@pytest.mark.skipif(not ORACLE.exists(), reason="oracle not built")
class TestCraftedStreams:
    """Self-built spec-valid streams exercising paths the real-world file
    does not: window transitions, stereo, square-polar coupling."""

    def _check(self, ch, pattern, tmp, coupling=False):
        from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
        rng = np.random.default_rng(7)
        spec = StreamSpec(channels=ch, sample_rate=44100, bs0=256,
                          bs1=1024, coupling=coupling)
        blocks = []
        for lng in pattern:
            half = (1024 if lng else 256) // 2
            r = np.zeros((ch, half), np.int64)
            m = rng.random((ch, half)) < 0.3
            r[m] = rng.integers(-2, 3, m.sum())
            blocks.append((lng, [(140, 120)] * ch, r))
        data = spec.build(blocks)
        fin, fout = tmp / "i.ogg", tmp / "o.raw"
        fin.write_bytes(data)
        subprocess.run([str(ORACLE), "decode", str(fin), str(fout)],
                       check=True, capture_output=True)
        ref = np.fromfile(fout, np.int16).reshape(-1, ch).T
        info, out = decode_vorbis(data)
        assert out.shape == ref.shape
        d = np.abs(out.astype(np.float64) - ref.astype(np.float64))
        assert d.max() <= 1, f"max diff {d.max()}"

    MIXED = [True, True, False, True, False, False, True, True, False,
             True]

    def test_mono_window_transitions(self, tmp_path):
        self._check(1, self.MIXED, tmp_path)

    def test_all_short(self, tmp_path):
        self._check(1, [False] * 8, tmp_path)

    def test_stereo_uncoupled(self, tmp_path):
        self._check(2, self.MIXED, tmp_path)

    def test_stereo_square_polar_coupling(self, tmp_path):
        self._check(2, self.MIXED, tmp_path, coupling=True)


@pytest.mark.skipif(not REAL_OGG.exists(), reason="no real-world vector")
class TestSeek:
    def test_coarse_seek_resumes(self):
        from ohpipeline_jax.codecs import BufferReader
        raw = REAL_OGG.read_bytes()
        codec = CodecVorbis()
        r = BufferReader(raw)
        info = codec.stream_initialise(r)
        assert info.seekable
        _info2, full = decode_vorbis(raw)
        target = 40000
        byte = codec.try_seek(target)
        assert 0 < byte < len(raw)
        r._pos = byte
        parts = []
        while True:
            try:
                parts.append(codec.process(r).resolve())
            except Exception:
                break
        out = np.concatenate(parts, axis=1)
        # resumed decode: substantial audio with energy comparable to the
        # tail of the full decode (coarse landing, not sample-aligned)
        assert out.shape[1] > 10000
        tail_rms = np.sqrt((full[:, target:].astype(np.float64) ** 2)
                           .mean())
        out_rms = np.sqrt((out.astype(np.float64) ** 2).mean())
        assert 0.2 * tail_rms < out_rms < 5 * tail_rms


@pytest.mark.skipif(not REAL_OGG.exists(), reason="no real-world vector")
class TestRealFile:
    def test_recognise(self):
        raw = REAL_OGG.read_bytes()
        assert CodecVorbis().recognise(raw[:4096])
        assert not CodecVorbis().recognise(b"\x00" * 64)

    @pytest.mark.skipif(not ORACLE.exists(), reason="oracle not built")
    def test_matches_tremor(self, tmp_path):
        raw = REAL_OGG.read_bytes()
        fout = tmp_path / "o.raw"
        subprocess.run([str(ORACLE), "decode", str(REAL_OGG), str(fout)],
                       check=True, capture_output=True)
        ref = np.fromfile(fout, np.int16)[None, :]
        info, out = decode_vorbis(raw)
        assert info.sample_rate == 11025 and info.num_channels == 1
        assert out.shape == ref.shape       # exact granule-trimmed length
        d = np.abs(out.astype(np.float64) - ref.astype(np.float64))
        assert d.max() <= 1, f"max diff {d.max()}"

    def test_registry_pipeline_decode(self):
        from ohpipeline_jax.codecs import default_registry
        raw = REAL_OGG.read_bytes()
        codec = default_registry.recognise(raw[:4096])
        assert codec is not None and codec.name == "Vorbis"
