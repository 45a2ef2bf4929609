"""The PUBLIC serving entry points under a device mesh.

SURVEY §2.7's stream-concurrency claim is certified on the functions
users actually call: decode_{flac,aac,mp3,he}_streams_device with
``mesh=`` shard their stream axis over dp (parallel.serving_put) and
must return the single-device results — bit-exactly for the integer
FLAC path; within a few 16-bit LSB for the float32 paths, where XLA's
sharded layouts reorder reductions (same stance as the dryrun's
tolerance).  The CPU devices come from conftest's
--xla_force_host_platform_device_count=8.
"""
import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, ".oracle_build", "aac_oracle")
AAC_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "assets", "dryrun.aac")


def _mesh(n=8):
    import jax
    if len(jax.devices()) < n:
        pytest.skip(f"needs the {n}-device CPU mesh")
    return parallel.make_mesh(n)


@pytest.mark.parametrize("n", [4, 8])
def test_make_mesh_shards_streams_over_every_device(n):
    """All devices go on the stream axis: a serving plane of 16 rows per
    device lands as one 16-row shard on each of the n devices."""
    mesh = _mesh(n)
    assert dict(mesh.shape) == {"dp": n}
    rows = np.arange(16 * n * 3, dtype=np.int32).reshape(16 * n, 3)
    placed = parallel.serving_put(mesh, rows, 0)
    shards = placed.addressable_shards
    assert len({sh.device for sh in shards}) == n
    assert all(sh.data.shape == (16, 3) for sh in shards)
    np.testing.assert_array_equal(np.asarray(placed), rows)
    # a shared plane replicates
    assert parallel.serving_put(mesh, rows[:5]).sharding.is_fully_replicated


def _close(r, g, lsb=24, snr_db=70.0):
    """float32 paths: sharded layouts reorder reductions; allow a few
    LSB peak and require high SNR vs the single-device result."""
    assert r.shape == g.shape
    d = (g.astype(np.float64) - r).ravel()
    assert np.abs(d).max() <= lsb, np.abs(d).max()
    p = float((r.astype(np.float64) ** 2).mean())
    if p > 1.0:
        snr = 10 * np.log10(p / max(float((d ** 2).mean()), 1e-30))
        assert snr >= snr_db, snr


def _pcm(seed, secs=1.5, rate=44100):
    t = np.arange(int(rate * secs)) / rate
    rng = np.random.default_rng(seed)
    x = (np.sin(2 * np.pi * (300 + 70 * seed) * t) * 9000
         + rng.standard_normal(len(t)) * 600)
    return np.stack([x, 0.6 * x]).astype(np.int32)


@pytest.mark.parametrize("n", [4, 8])
def test_flac_streams_mesh_parity(n):
    from ohpipeline_jax.codecs import flac
    from ohpipeline_jax.codecs.flac import serving as FS
    mesh = _mesh(n)
    streams = [flac.encode_flac(_pcm(s), 44100, 16, blocksize=1024)
               for s in range(4)]
    ref = FS.decode_flac_streams_device(streams,
                                                  frames_per_group=8)
    got = FS.decode_flac_streams_device(streams,
                                                  frames_per_group=8,
                                                  mesh=mesh)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


def _mp3_stream(seed: int, nframes: int) -> bytes:
    from ohpipeline_jax.codecs.mp3 import encoder as ENC
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.22
        spec[m] = rng.integers(1, 12, m.sum())
        spec[rng.random((2, 576)) < 0.5] *= -1
        frames.append(ENC.build_frame(
            [spec[0], spec[1]],
            global_gain=int(rng.integers(172, 186))))
    return b"".join(frames)


def test_mp3_streams_mesh_parity():
    from ohpipeline_jax.codecs.mp3 import serving as MS
    mesh = _mesh()
    streams = [_mp3_stream(s, 12 + 7 * s) for s in range(4)]
    ref = MS.decode_mp3_streams_device(streams, frames_per_group=16)
    got = MS.decode_mp3_streams_device(streams, frames_per_group=16,
                                       mesh=mesh)
    for r, g in zip(ref, got):
        _close(r, g)


def test_aac_streams_mesh_parity():
    from ohpipeline_jax.codecs.aac import serving as AS
    mesh = _mesh()
    if not os.path.exists(AAC_ASSET):
        pytest.skip("no ADTS asset")
    data = open(AAC_ASSET, "rb").read()
    # distinct lengths per stream: cut at different frame boundaries
    from ohpipeline_jax.codecs.aac.bitstream import parse_adts_header
    cuts, pos, k = [], 0, 0
    while pos < len(data):
        h = parse_adts_header(data, pos)
        if h is None:
            break
        pos += h.frame_bytes
        k += 1
        if k in (6, 9, 12):
            cuts.append(pos)
    streams = [data[:c] for c in cuts] + [data]
    ref = AS.decode_aac_streams_device(streams, frames_per_group=4)
    got = AS.decode_aac_streams_device(streams, frames_per_group=4,
                                       mesh=mesh)
    for r, g in zip(ref, got):
        _close(r, g)


@pytest.mark.skipif(not os.path.exists(ORACLE),
                    reason="aac oracle not built")
def test_he_streams_mesh_parity():
    from ohpipeline_jax.codecs.aac import serving as AS
    mesh = _mesh()
    streams = []
    for s in range(2):
        pcm = np.clip(_pcm(s, secs=1.2).T, -32768,
                      32767).astype(np.int16).copy()
        with tempfile.TemporaryDirectory() as td:
            fin = os.path.join(td, "i.raw")
            fout = os.path.join(td, "o.aac")
            pcm.tofile(fin)
            subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                            "48000", "2", "5"], check=True,
                           capture_output=True)
            streams.append(open(fout, "rb").read())
    ref = AS.decode_he_streams_device(streams, frames_per_group=8)
    got = AS.decode_he_streams_device(streams, frames_per_group=8,
                                      mesh=mesh)
    for r, g in zip(ref, got):
        _close(r, g)
