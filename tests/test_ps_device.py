"""Device parametric stereo (HE-AAC v2) vs the numpy PsDecoder chain.

The numpy PS path (codecs/aac/sbr.py PsDecoder, conformance-tested
against libSBRdec+PS in tests/test_sbr.py) is the oracle; the batched
device stage (sbr_jax.ps_decorrelate_mix under one scan + hybrid FIR
matmuls + host-interpolated rotation matrices) must reproduce it to
float32 accuracy over multi-frame groups."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "aac_oracle")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="aac oracle not built")


def _v2_stream(secs: float = 2.5) -> bytes:
    t = np.arange(int(44100 * secs)) / 44100.0
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
        return open(fout, "rb").read()


def test_ps_device_matches_numpy():
    from ohpipeline_jax.codecs.aac import (_StreamState,
                                           decode_frames_float)
    from ohpipeline_jax.codecs.aac import bitstream as BS
    from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
    from ohpipeline_jax.codecs.aac.sbr_jax import SbrPsDeviceRunner
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    data = _v2_stream()
    frames = []
    pos = 0
    hdr0 = None
    while True:
        h = BS.parse_adts_header(data, pos)
        if h is None or pos + h.frame_bytes > len(data):
            break
        hdr0 = hdr0 or h
        br = BitReader(data, (pos + h.header_bytes) * 8)
        frames.append(BS.parse_raw_data_block(br, h.rate_index))
        pos += h.frame_bytes
    assert len(frames) >= 50

    dec_np = SbrDecoder(hdr0.sample_rate)
    st_np = _StreamState(1)
    dec_dev = SbrDecoder(hdr0.sample_rate)
    st_dev = _StreamState(1)
    outs_np = []
    parsed = []
    runner = None
    has_ps = 0
    for fr in frames:
        core_np = decode_frames_float([fr], st_np)
        core_dev = decode_frames_float([fr], st_dev)
        payload, nbits, crc = fr.sbr
        chans, _c = dec_np.parse_payload(payload, nbits, stereo=False,
                                         crc=crc)
        outs_np.append(dec_np.process_frame_ps(core_np, chans))
        chans2, _c2 = dec_dev.parse_payload(payload, nbits,
                                            stereo=False, crc=crc)
        if runner is None:
            runner = SbrPsDeviceRunner(dec_dev)
        E, Q, _a = dec_dev.dequant(dec_dev.header, chans2[0].grid,
                                   chans2[0].env, chans2[0].noise)
        has_ps += chans2[0].ps is not None
        parsed.append((core_dev[0], chans2[0], E, Q, chans2[0].ps))
    assert has_ps > 0
    ref = np.concatenate(outs_np, axis=1)

    outs_dev = []
    for g0 in range(0, len(parsed), 32):
        chunk = parsed[g0:g0 + 32]
        pcm = np.stack([c[0].reshape(1024) for c in chunk])
        outs_dev.append(runner.decode_group(
            pcm, [c[1] for c in chunk], [c[2] for c in chunk],
            [c[3] for c in chunk], [c[4] for c in chunk]))
    got = np.concatenate(outs_dev, axis=1)
    n = min(ref.shape[1], got.shape[1])
    err = got[:, :n] - ref[:, :n]
    peak = max(np.abs(ref).max(), 1.0)
    rel = np.abs(err).max() / peak
    rms = np.sqrt((err ** 2).mean()) / np.sqrt((ref ** 2).mean() + 1e-9)
    assert rel < 5e-3, f"max rel err {rel:.2e}"
    assert rms < 1e-3, f"rms rel err {rms:.2e}"


def test_codec_uses_device_ps_path():
    """CodecAacAdts on a v2 stream must take the batched device route
    (SbrPsDeviceRunner attached), not silently fall back to numpy."""
    from ohpipeline_jax.codecs.aac import CodecAacAdts
    from ohpipeline_jax.codecs.base import EndOfStream

    class _Rdr:
        def __init__(self, b):
            self._b, self._p = b, 0
            self.stream_bytes = len(b)

        def read(self, n):
            out = self._b[self._p:self._p + n]
            self._p += len(out)
            return out

        def peek(self, n):
            return self._b[self._p:self._p + n]

    data = _v2_stream(1.5)
    c = CodecAacAdts()
    r = _Rdr(data)
    assert c.recognise(r.peek(8192))
    info = c.stream_initialise(r)
    assert info.codec_name == "HE-AAC v2"
    try:
        while True:
            c.process(r).resolve()
    except EndOfStream:
        pass
    assert getattr(c._sbr, "_ps_device_runner", None) is not None, \
        "v2 decode silently fell back to the numpy PS path"
