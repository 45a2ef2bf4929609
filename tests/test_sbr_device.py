"""Device (jax) SBR group decode vs the numpy per-frame chain.

The numpy SbrDecoder in codecs/aac/sbr.py is the conformance-tested
oracle (tests/test_sbr.py bounds it against libSBRdec); the batched
device path in codecs/aac/sbr_jax.py must reproduce it to float32
accuracy across multi-frame streams including coupling and transient
(sine/noise) frames."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "aac_oracle")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="aac oracle not built")


def _content(kind: str, secs: float = 2.5) -> np.ndarray:
    t = np.arange(int(44100 * secs)) / 44100.0
    rng = np.random.default_rng(11)
    if kind == "noise":
        x = rng.standard_normal(len(t)) * 4000
    elif kind == "transient":
        x = rng.standard_normal(len(t)) * 1500
        for s in range(0, len(t) - 900, 5000):
            x[s:s + 700] += (np.sign(np.sin(2 * np.pi * 41 * t[:700]))
                             * np.exp(-t[:700] * 250) * 11000)
    else:
        x = (np.sin(2 * np.pi * 900 * t) * 8000
             * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t))
             + np.sin(2 * np.pi * 6200 * t) * 5000
             + rng.standard_normal(len(t)) * 800)
    return np.clip(x, -32000, 32000).astype(np.int16)


def _encode_he(x: np.ndarray, bitrate: int = 48000) -> bytes:
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        str(bitrate), "2", "5"], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _parse_he(data: bytes, max_frames: int = 200):
    """ADTS HE-AAC -> (core_rate, channels, list of parsed frames)."""
    from ohpipeline_jax.codecs.aac import bitstream as BS
    from ohpipeline_jax.codecs.flac.bitreader import BitReader
    frames = []
    pos = 0
    hdr0 = None
    while len(frames) < max_frames:
        hdr = BS.parse_adts_header(data, pos)
        if hdr is None or pos + hdr.frame_bytes > len(data):
            break
        hdr0 = hdr0 or hdr
        br = BitReader(data, (pos + hdr.header_bytes) * 8)
        frames.append(BS.parse_raw_data_block(br, hdr.rate_index))
        pos += hdr.frame_bytes
    return hdr0, frames


def test_core_imdct_device_matches_host():
    """The fused on-device LC core (core_imdct_device) must reproduce
    the host float path (_core_float_from_specs) across chained groups
    with mixed long/short windows, including the overlap tail it hands
    back for numpy-fallback resync."""
    import jax.numpy as jnp

    from ohpipeline_jax.codecs.aac import (_StreamState,
                                           _core_float_from_specs)
    from ohpipeline_jax.codecs.aac.sbr_jax import core_imdct_device
    rng = np.random.default_rng(5)
    state = _StreamState(1)
    ov_dev = np.zeros(1024, np.float32)
    for _ in range(3):                       # chained groups
        F = 6
        specs = (rng.standard_normal((F, 1, 1024)) * 300) \
            .astype(np.float32)
        # ops: window_sequence*4 + prev_shape*2 + shape; cycle through
        # long starts/stops and EIGHT_SHORT rows
        seqs = np.array([0, 1, 2, 2, 3, 0], np.int32)
        ops = (seqs * 4 + rng.integers(0, 4, F)).astype(np.int32) \
            .reshape(F, 1)
        ref = _core_float_from_specs(specs, ops, state)   # (1, F*1024)
        got, ov_dev = core_imdct_device(jnp.asarray(specs[:, 0]),
                                        jnp.asarray(ops[:, 0]),
                                        jnp.asarray(ov_dev))
        got = np.asarray(got).reshape(-1)
        err = np.abs(got - ref[0]).max()
        scale = max(np.abs(ref).max(), 1.0)
        assert err / scale < 1e-5, err / scale
        # the device overlap tail (what fetch_core_overlap hands the
        # host on fallback) must match the host state's
        ov_err = np.abs(np.asarray(ov_dev) - state.overlap[0]).max()
        assert ov_err / scale < 1e-5, ov_err / scale
        ov_dev = np.asarray(ov_dev)


def test_fused_core_overlap_resync():
    """After spec-mode device groups, _sync_core_overlap must hand the
    host _StreamState the same overlap tail the host float path would
    have produced — the continuity contract for numpy-fallback groups."""
    from ohpipeline_jax.codecs.aac import (_StreamState,
                                           _sbr_decode_frames_lazy,
                                           _sync_core_overlap,
                                           decode_frames_float_batched)
    from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
    data = _encode_he(_content("mix", 1.5))
    hdr, frames = _parse_he(data)
    sbr = SbrDecoder(hdr.sample_rate)
    state = _StreamState(hdr.channels)
    twin = _StreamState(hdr.channels)
    for g0 in range(0, 64, 32):
        chunk = frames[g0:g0 + 32]
        resolve, _ns = _sbr_decode_frames_lazy(chunk, state, sbr,
                                               hdr.channels)
        out = resolve()
        assert out.shape[0] == hdr.channels
        decode_frames_float_batched(chunk, twin)   # host-path twin
    assert getattr(sbr, "_device_runner", None) is not None, \
        "stream did not take the spec-mode device path"
    assert sbr._device_runner._core_ov is not None
    _sync_core_overlap(sbr, state)
    assert sbr._device_runner._core_ov is None
    scale = max(np.abs(twin.overlap).max(), 1.0)
    assert np.abs(state.overlap - twin.overlap).max() / scale < 1e-5


@pytest.mark.parametrize("kind", ["mix", "noise", "transient"])
def test_sbr_device_matches_numpy(kind):
    from ohpipeline_jax.codecs.aac import (_StreamState,
                                           decode_frames_float)
    from ohpipeline_jax.codecs.aac.sbr import SbrDecoder
    from ohpipeline_jax.codecs.aac.sbr_jax import SbrDeviceRunner
    data = _encode_he(_content(kind))
    hdr, frames = _parse_he(data)
    nch = hdr.channels
    assert nch == 2 and len(frames) >= 40

    # numpy oracle path
    dec_np = SbrDecoder(hdr.sample_rate)
    state_np = _StreamState(nch)
    outs_np = []
    # device path shares one decoder for parsing (separate synth state)
    dec_dev = SbrDecoder(hdr.sample_rate)
    state_dev = _StreamState(nch)
    runner = None
    parsed = []
    for fr in frames:
        core_np = decode_frames_float([fr], state_np)
        core_dev = decode_frames_float([fr], state_dev)
        assert fr.sbr is not None
        payload, nbits, crc = fr.sbr
        chans, coupling = dec_np.parse_payload(payload, nbits,
                                               stereo=True, crc=crc)
        outs_np.append(dec_np.process_frame(core_np, chans, coupling))
        chans2, coupling2 = dec_dev.parse_payload(payload, nbits,
                                                  stereo=True, crc=crc)
        if runner is None:
            runner = SbrDeviceRunner(dec_dev)
        EQ = [dec_dev.dequant(dec_dev.header, chans2[i].grid,
                              chans2[i].env, chans2[i].noise)
              for i in range(nch)]
        if coupling2:
            a = EQ[0][2]
            (EL, QL), (ER, QR) = dec_dev.unmap_coupled(
                EQ[0][0], EQ[0][1], chans2[1].env, chans2[1].noise, a)
            EQ = [(EL, QL, a), (ER, QR, a)]
        parsed.append((core_dev, chans2, EQ))
    ref = np.concatenate(outs_np, axis=1)

    # device decode in groups of 32 frames
    F = len(parsed)
    outs_dev = [[] for _ in range(nch)]
    for g0 in range(0, F, 32):
        chunk = parsed[g0:g0 + 32]
        for ch in range(nch):
            pcm = np.stack([c[0][ch] for c in chunk])
            datas = [c[1][ch] for c in chunk]
            Es = [c[2][ch][0] for c in chunk]
            Qs = [c[2][ch][1] for c in chunk]
            outs_dev[ch].append(runner.decode_group(ch, pcm, datas,
                                                    Es, Qs))
    got = np.stack([np.concatenate(o) for o in outs_dev])

    n = min(ref.shape[1], got.shape[1])
    err = got[:, :n] - ref[:, :n]
    peak = max(np.abs(ref).max(), 1.0)
    rel = np.abs(err).max() / peak
    rms = np.sqrt((err ** 2).mean()) / np.sqrt((ref ** 2).mean() + 1e-9)
    assert rel < 2e-3, f"max rel err {rel:.2e}"
    assert rms < 5e-4, f"rms rel err {rms:.2e}"
