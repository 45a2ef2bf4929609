"""Device (batched) Vorbis synthesis vs the host path.

The host synthesis (synthesis.imdct_many + Lapper, float64) is the
conformance oracle — itself validated 1 LSB against the Tremor oracle
in test_vorbis.py — so device-vs-host here bounds the whole device
path: int16-spectrum wire, f32 matmuls, scatter overlap-add and
the group-to-group lap carry."""

import numpy as np

from ohpipeline_jax.codecs.vorbis import vorbis_jax
from ohpipeline_jax.codecs.vorbis.encoder import StreamSpec
from ohpipeline_jax.codecs.vorbis.synthesis import Lapper, imdct_many


def _make_stream(seed, nblocks=40, coupling=True, mode="mixed", ch=2):
    rng = np.random.default_rng(seed)
    spec = StreamSpec(channels=ch, sample_rate=44100, bs0=256, bs1=1024,
                      coupling=coupling)
    blocks = []
    for _ in range(nblocks):
        if mode == "mixed":
            lng = int(rng.random() < 0.7)
        else:
            lng = 1 if mode == "long" else 0
        half = 512 if lng else 128
        r = np.zeros((ch, half), np.int64)
        m = rng.random((ch, half)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        fy = [(int(rng.integers(100, 200)), int(rng.integers(80, 200)))
              for _ in range(ch)]
        blocks.append((lng, fy, r))
    return spec.build(blocks)


def _host_pcm(data):
    info, blocks = vorbis_jax.capture_stream(data)
    lap = Lapper(info.channels, info.blocksize[0])
    outs = [lap.add_block(imdct_many(spec, n), n, pf, nf)
            for n, pf, nf, spec in blocks]
    pcm = np.concatenate(outs, axis=1)
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int32)


def _snr(ref, x):
    err = ref.astype(np.float64) - x.astype(np.float64)
    p = float((ref.astype(np.float64) ** 2).sum())
    e = float((err ** 2).sum())
    return 10 * np.log10(p / max(e, 1e-30))


def test_device_matches_host_mixed_blocks():
    data = _make_stream(1, nblocks=50, mode="mixed")
    ref = _host_pcm(data)
    out = vorbis_jax.decode_vorbis_stream_device(data).astype(np.int32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2
    assert _snr(ref, out) >= 60.0


def test_device_all_long_and_all_short():
    for mode in ("long", "short"):
        data = _make_stream(2, nblocks=30, mode=mode, coupling=False, ch=1)
        ref = _host_pcm(data)
        out = vorbis_jax.decode_vorbis_stream_device(data).astype(np.int32)
        assert out.shape == ref.shape, mode
        assert np.abs(out - ref).max() <= 2, mode


def test_group_carry_lapping():
    """Small groups force the carry path; result must stay within the
    same bounds, and near-identical to a one-group decode."""
    data = _make_stream(3, nblocks=37, mode="mixed")
    ref = _host_pcm(data)
    small = vorbis_jax.decode_vorbis_stream_device(data, group=8) \
        .astype(np.int32)
    big = vorbis_jax.decode_vorbis_stream_device(data, group=64) \
        .astype(np.int32)
    assert np.abs(small - ref).max() <= 2
    assert np.abs(small - big).max() <= 1


def test_multistream_batch_matches_single():
    streams = [_make_stream(10 + i, nblocks=20 + 7 * i, mode="mixed")
               for i in range(3)]
    batch = vorbis_jax.decode_vorbis_streams_device(streams, group=16)
    for s, data in enumerate(streams):
        one = vorbis_jax.decode_vorbis_stream_device(data, group=16)
        assert batch[s].shape == one.shape
        assert np.abs(batch[s].astype(np.int32)
                      - one.astype(np.int32)).max() <= 1


def test_device_matches_host_real_file():
    """A real encoder's stream (libvorbis: full floor1/residue configs,
    real codebooks, mixed windows) through the device path."""
    import pathlib
    real = pathlib.Path(
        "/opt/venv/lib/python3.12/site-packages/pygame/examples/data/"
        "house_lo.ogg")
    if not real.exists():
        import pytest
        pytest.skip("real ogg asset unavailable")
    data = real.read_bytes()
    ref = _host_pcm(data)
    out = vorbis_jax.decode_vorbis_stream_device(data).astype(np.int32)
    assert out.shape == ref.shape
    # real spectra have higher crest than the synthetic vectors, so the
    # per-block int16 wire lands a few LSB off peak samples (measured
    # 5 LSB / 80 dB); the SNR bound is the meaningful one
    assert np.abs(out - ref).max() <= 6
    assert _snr(ref, out) >= 70.0
