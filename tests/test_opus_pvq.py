"""CWRS/PVQ + Laplace conformance vs the reference encoders
(tools/celt_probe.c)."""

import json
import os
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs.opus import pvq
from ohpipeline_jax.codecs.opus.range_dec import RangeDecoder

PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "celt_probe")

pytestmark = pytest.mark.skipif(not os.path.exists(PROBE),
                                reason="celt_probe not built")


@pytest.mark.parametrize("n,k", [(2, 1), (2, 3), (3, 2), (4, 4), (8, 5),
                                 (16, 10), (24, 3), (48, 3), (96, 2),
                                 (176, 1)])
def test_cwrs_roundtrip(n, k):
    for seed in (1, 5, 77, 900):
        out = json.loads(subprocess.run(
            [PROBE, "cwrs", str(n), str(k), str(seed)],
            capture_output=True, check=True).stdout)
        dec = RangeDecoder(bytes.fromhex(out["bytes"]))
        y = pvq.decode_pulses(dec, n, k)
        np.testing.assert_array_equal(y, out["y"][:n])


@pytest.mark.parametrize("fs,decay", [(9000, 200), (6000, 4000),
                                      (1000, 10000), (601, 6700)])
def test_laplace(fs, decay):
    for seed in (4, 19, 333):
        out = json.loads(subprocess.run(
            [PROBE, "laplace", str(fs), str(decay), str(seed), "30"],
            capture_output=True, check=True).stdout)
        dec = RangeDecoder(bytes.fromhex(out["bytes"]))
        got = [pvq.laplace_decode(dec, fs, decay) for _ in range(30)]
        assert got == out["vals"]
