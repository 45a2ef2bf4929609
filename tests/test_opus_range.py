"""Range decoder conformance vs the reference range encoder: random
symbol schedules encoded by opus's ec_enc (tools/celt_probe.c) must
decode symbol-for-symbol (RFC 6716 s4.1)."""

import json
import os
import subprocess

import pytest

from ohpipeline_jax.codecs.opus.range_dec import RangeDecoder

PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "celt_probe")

pytestmark = pytest.mark.skipif(not os.path.exists(PROBE),
                                reason="celt_probe not built")

ICDF_T = [
    [2, 1, 0],
    [6, 3, 1, 0],
    [10, 8, 6, 4, 2, 1, 0],
    [96, 64, 32, 16, 8, 4, 2, 0],
]
ICDF_FTB = [2, 3, 4, 7]


@pytest.mark.parametrize("seed", [1, 2, 3, 17, 99, 12345])
def test_symbol_schedules(seed):
    out = json.loads(subprocess.run(
        [PROBE, "ecenc", str(seed), "200"],
        capture_output=True, check=True).stdout)
    data = bytes.fromhex(out["bytes"])
    dec = RangeDecoder(data)
    for kind, a, b in out["schedule"]:
        if kind == 0:                      # bit_logp(logp) -> bit
            assert dec.dec_bit_logp(a) == b, (kind, a, b)
        elif kind == 1:                    # bits(n) -> v
            assert dec.dec_bits(a) == b, (kind, a, b)
        elif kind == 2:                    # uint(ft) -> v
            assert dec.dec_uint(a) == b, (kind, a, b)
        else:                              # icdf(table t) -> v
            assert dec.dec_icdf(ICDF_T[a], ICDF_FTB[a]) == b, (kind, a, b)
    assert not dec.error


def test_tell_progresses():
    out = json.loads(subprocess.run(
        [PROBE, "ecenc", "7", "50"], capture_output=True,
        check=True).stdout)
    dec = RangeDecoder(bytes.fromhex(out["bytes"]))
    last = dec.tell()
    assert last >= 1
    for kind, a, b in out["schedule"]:
        if kind == 0:
            dec.dec_bit_logp(a)
        elif kind == 1:
            dec.dec_bits(a)
        elif kind == 2:
            dec.dec_uint(a)
        else:
            dec.dec_icdf(ICDF_T[a], ICDF_FTB[a])
        now = dec.tell()
        assert now >= last
        assert dec.tell_frac() >= now * 8 - 8
        last = now
