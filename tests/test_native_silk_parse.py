"""Native SILK packet parser (silk_parse.cc) vs the Python fallback.

The Python parse layer in codecs/opus/silk.py (parse_silk_packet /
parse_silk_packet_stereo, forced with OHP_SILK_PY=1) is the behaviour
oracle for the C++ parser: every decoded symbol feeds integer synthesis,
so the int16/int32 PCM must agree bit-for-bit across modes, durations
and the hybrid range-coder handoff.

Conformance vs the real libopus decoder is covered by
tests/test_opus_silk.py, which exercises the native path by default.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native

ORACLE = pathlib.Path(__file__).resolve().parent.parent \
    / ".oracle_build" / "opus_oracle"

pytestmark = pytest.mark.skipif(
    not native.have_silk_core(), reason="native silk core unavailable")


def _encode(pcm: np.ndarray, mode: str, bitrate: int) -> bytes:
    ch = pcm.shape[0]
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(ch),
                        str(bitrate), mode], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _content(seconds: float, ch: int) -> np.ndarray:
    rate = 48000
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(11)
    x = (np.sin(2 * np.pi * 300 * t) * 9000
         * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))
         + rng.standard_normal(len(t)) * 800)
    x = np.clip(x, -32000, 32000)
    if ch == 2:
        return np.stack([x, np.roll(x, 23)]).astype(np.int16)
    return x[None, :].astype(np.int16)


@pytest.mark.parametrize("ch,mode,bitrate", [
    (1, "silk", 24000),
    (2, "silk", 48000),
    (1, "hybrid", 32000),
    (1, "silkfec", 24000),          # LBRR flags + frames on the wire
])
def test_native_parse_matches_python_fallback(ch, mode, bitrate,
                                              monkeypatch):
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    from ohpipeline_jax.codecs.opus import decode_opus
    data = _encode(_content(2.0, ch), mode, bitrate)

    monkeypatch.setenv("OHP_SILK_PY", "1")
    _, pcm_py = decode_opus(data)
    monkeypatch.delenv("OHP_SILK_PY")
    _, pcm_nat = decode_opus(data)

    assert pcm_py.shape == pcm_nat.shape
    np.testing.assert_array_equal(pcm_py, pcm_nat)


def test_native_parse_lbrr_frames_match(monkeypatch):
    """decode_fec path: the LBRR frame slots the native parser returns
    must match the Python parser's (indices and pulses)."""
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    from ohpipeline_jax.codecs import opus_headers
    from ohpipeline_jax.codecs.opus import split_packet_frames
    from ohpipeline_jax.codecs.opus import silk as S
    from ohpipeline_jax.containers.ogg import OggReader
    from ohpipeline_jax.codecs.base import BufferReader

    data = _encode(_content(2.0, 1), "silkfec", 24000)
    ogg = OggReader(BufferReader(data))
    packets = list(ogg.packets())[2:]
    n_with_lbrr = 0
    for pk in packets:
        toc, frames = split_packet_frames(pk)
        if toc.mode != "silk":
            continue
        for f in frames:
            lbrr_nat: list = []
            lbrr_py: list = []
            fr_nat = S.parse_silk_packet(f, toc.bandwidth,
                                         duration_ms=int(toc.frame_ms),
                                         lbrr_out=lbrr_nat)
            monkeypatch.setenv("OHP_SILK_PY", "1")
            fr_py = S.parse_silk_packet(f, toc.bandwidth,
                                        duration_ms=int(toc.frame_ms),
                                        lbrr_out=lbrr_py)
            monkeypatch.delenv("OHP_SILK_PY")
            assert len(lbrr_nat) == len(lbrr_py)
            for a, b in zip(lbrr_nat, lbrr_py):
                assert (a is None) == (b is None)
                if a is None:
                    continue
                n_with_lbrr += 1
                assert a.indices.gain_indices == b.indices.gain_indices
                assert a.indices.signal_type == b.indices.signal_type
                np.testing.assert_array_equal(
                    np.asarray(a.indices.pulses, np.int64),
                    np.asarray(b.indices.pulses, np.int64))
            for a, b in zip(fr_nat, fr_py):
                assert a.vad == b.vad
                import dataclasses
                for fld in dataclasses.fields(a.indices):
                    if fld.name == "pulses":
                        continue
                    assert getattr(a.indices, fld.name) \
                        == getattr(b.indices, fld.name), fld.name
                np.testing.assert_array_equal(
                    np.asarray(a.indices.pulses, np.int64),
                    np.asarray(b.indices.pulses, np.int64))
    assert n_with_lbrr > 0          # the silkfec stream must carry LBRR


def test_native_parse_is_active():
    """The default decode path must actually use silk_parse.cc (no
    silent permanent fallback)."""
    from ohpipeline_jax.codecs.opus import silk as S
    assert S._use_native_parse()
