"""CELT bit allocation conformance vs clt_compute_allocation
(tools/celt_probe.c `alloc`): pulses/ebits/priorities/coded bands and the
range-decoder state after skip/intensity/dual decisions must all match."""

import json
import os
import subprocess

import numpy as np
import pytest

from ohpipeline_jax.codecs.opus import alloc
from ohpipeline_jax.codecs.opus.mode import celt_mode
from ohpipeline_jax.codecs.opus.range_dec import RangeDecoder

PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "celt_probe")

pytestmark = pytest.mark.skipif(not os.path.exists(PROBE),
                                reason="celt_probe not built")


CASES = [(C, LM, total, trim, seed)
         for C in (1, 2)
         for LM in (0, 1, 2, 3)
         for total, trim, seed in ((1500, 5, 42), (400, 2, 7),
                                   (6000, 9, 3), (100, 5, 11),
                                   (2500, 0, 99))]


@pytest.mark.parametrize("C,LM,total,trim,seed", CASES)
def test_allocation_matches_reference(C, LM, total, trim, seed):
    out = json.loads(subprocess.run(
        [PROBE, "alloc", "960", str(C), str(LM), str(total), str(trim),
         str(seed)], capture_output=True, check=True).stdout)
    mode = celt_mode()
    dec = RangeDecoder(bytes.fromhex(out["scratch"]))
    a = alloc.compute_allocation(
        mode, 0, mode.eff_ebands, np.asarray(out["offsets"], np.int64),
        np.asarray(out["cap"], np.int64), trim, total, C, LM, dec)
    assert a.coded_bands == out["coded"]
    assert a.intensity == out["intensity"]
    assert a.dual_stereo == out["dual"]
    assert a.balance == out["balance"]
    np.testing.assert_array_equal(a.pulses, out["pulses"])
    np.testing.assert_array_equal(a.ebits, out["ebits"])
    np.testing.assert_array_equal(a.fine_priority, out["prio"])
    assert dec.tell_frac() == out["tell_frac"]


def test_caps_match_reference():
    out = json.loads(subprocess.run(
        [PROBE, "alloc", "960", "2", "3", "1500", "5", "1"],
        capture_output=True, check=True).stdout)
    mode = celt_mode()
    np.testing.assert_array_equal(alloc.init_caps(mode, 3, 2), out["cap"])
