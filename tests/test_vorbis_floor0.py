"""Vorbis floor 0 (legacy LSP floor) conformance: crafted floor0 streams
cross-decoded against the reference's Tremor oracle (spec s6.2, Tremor
floor0.c)."""

import pathlib
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs.vorbis import decode_vorbis
from ohpipeline_jax.codecs.vorbis.encoder import StreamSpecFloor0

ORACLE = pathlib.Path(__file__).resolve().parent.parent / \
    ".oracle_build" / "vorbis_oracle"

pytestmark = pytest.mark.skipif(not ORACLE.exists(),
                                reason="vorbis oracle not built")


def _blocks(spec, nblocks, rng, channels):
    blocks = []
    for i in range(nblocks):
        lng = True
        half = spec.bs[1] // 2
        res = rng.integers(-2, 3, size=(channels, half))
        fy = [(20 + int(rng.integers(0, 30)),
               [int(rng.integers(0, 4)), int(rng.integers(0, 4))])
              for _ in range(channels)]
        blocks.append((lng, fy, res))
    return blocks


def _cross_decode(data, ch, tmp_path):
    fin, fout = tmp_path / "i.ogg", tmp_path / "o.raw"
    fin.write_bytes(data)
    subprocess.run([str(ORACLE), "decode", str(fin), str(fout)],
                   check=True, capture_output=True)
    ref = np.fromfile(fout, np.int16).reshape(-1, ch).T
    info, out = decode_vorbis(data)
    assert out.shape == ref.shape
    d = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    return d.max()


def test_floor0_mono(tmp_path):
    rng = np.random.default_rng(5)
    spec = StreamSpecFloor0(channels=1)
    data = spec.build(_blocks(spec, 8, rng, 1))
    assert _cross_decode(data, 1, tmp_path) <= 2


def test_floor0_stereo_coupled(tmp_path):
    rng = np.random.default_rng(9)
    spec = StreamSpecFloor0(channels=2, coupling=True)
    data = spec.build(_blocks(spec, 8, rng, 2))
    assert _cross_decode(data, 2, tmp_path) <= 2


def test_floor0_high_amplitude(tmp_path):
    # near-max amplitude exercises the exp() end of the curve
    spec = StreamSpecFloor0(channels=1)
    rng = np.random.default_rng(2)
    blocks = []
    for _ in range(6):
        half = spec.bs[1] // 2
        res = rng.integers(-2, 3, size=(1, half))
        blocks.append((True, [(60, [0, 3])], res))
    data = spec.build(blocks)
    assert _cross_decode(data, 1, tmp_path) <= 2
