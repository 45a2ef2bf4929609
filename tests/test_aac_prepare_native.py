"""C aac_prepare_rows must assemble exactly what the Python
prepare_device_group + bench stacking produce (same device inputs)."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs import aac

pytestmark = pytest.mark.skipif(not native.have_aac_unpack(),
                                reason="native unpacker unavailable")

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "aac_oracle")


def _encode(track: np.ndarray, rate: int) -> bytes:
    if not os.path.exists(ORACLE):
        pytest.skip("aac oracle not built")
    with tempfile.TemporaryDirectory() as td:
        fin, fout = os.path.join(td, "i.raw"), os.path.join(td, "o.aac")
        np.ascontiguousarray(track.T).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, str(rate), "2",
                        "128000"], check=True, capture_output=True)
        return open(fout, "rb").read()


def test_prepare_rows_matches_python():
    rng = np.random.default_rng(3)
    rate, nch, F = 44100, 2, 32
    n = rate * 4
    t = np.arange(n) / rate
    x = (np.sin(2 * np.pi * 500 * t) * 12000
         + rng.standard_normal(n) * 800)
    # transient content to force short windows/groupings
    x[rate:rate + 2000] *= 0.01
    x[2 * rate:2 * rate + 400] += 15000 * np.sign(
        np.sin(2 * np.pi * 40 * t[:400]))
    track = np.stack([x, np.roll(x, 13)]).astype(np.int32)
    data = _encode(np.clip(track, -32000, 32000), rate)

    S = 2          # two streams stacked (columns) like the bench superstep
    pos = [0, 0]
    pshape_py = [np.zeros(nch, np.int32) for _ in range(S)]
    pshape_c = [np.zeros(nch, np.int32) for _ in range(S)]
    cfg = native.AacCfgMap(16)
    cfg_py: dict = {}          # persistent, like the C map
    steps = 0
    while steps < 10:
        batches = []
        for s in range(S):
            nfr, pos[s], b = native.aac_parse_group(data, pos[s],
                                                    channels=nch,
                                                    max_frames=F)
            batches.append((nfr, b))
        if batches[0][0] == 0:
            break
        steps += 1
        SC = S * nch
        q16 = np.zeros((F, SC, 1024), np.int16)
        sf16 = np.zeros((F, SC, 128), np.int16)
        coded = np.zeros((F, SC, 128), np.uint8)
        cfg_idx = np.zeros((F, SC), np.int32)
        ms_flag = np.zeros((F, SC // 2, 128), np.uint8)
        opidx = np.zeros((F, SC), np.int32)
        specials = []
        for s, (nfr, b) in enumerate(batches):
            r = native.aac_prepare_rows(
                b, nfr, F, nch, pshape_c[s], cfg,
                quant16=q16, sf16=sf16, coded=coded, cfg_idx=cfg_idx,
                ms_flag=ms_flag, opidx=opidx, col0=s * nch)
            assert r is not None
            specials.append(r[0])
            assert not r[1]          # no int16 overflow on this content

        # Python reference: prepare_device_group + bench-style stacking
        preps = []
        for s, (nfr, b) in enumerate(batches):
            prep = aac.prepare_device_group(b, F, nch, pshape_py[s], cfg_py)
            assert prep is not None
            preps.append(prep)
        stacked = {k: np.concatenate([p[k] for p in preps], axis=1)
                   for k in ("quant", "sf", "coded", "cfg_idx", "ms_flag",
                             "opidx")}

        np.testing.assert_array_equal(q16, stacked["quant"].astype(np.int16))
        np.testing.assert_array_equal(sf16, stacked["sf"])
        np.testing.assert_array_equal(coded, stacked["coded"])
        np.testing.assert_array_equal(ms_flag, stacked["ms_flag"])
        np.testing.assert_array_equal(opidx, stacked["opidx"])
        # cfg indices must agree under the key mapping
        cdict = cfg.as_dict()
        assert set(cdict) == set(cfg_py)
        remap = {cdict[k]: v for k, v in cfg_py.items()}
        np.testing.assert_array_equal(
            np.vectorize(remap.get)(cfg_idx), stacked["cfg_idx"])
        # special rows: python marks rows via side_row >= 0
        for s, prep in enumerate(preps):
            py_special = sorted({int(r) // nch
                                 for r in prep["side_row"] if r >= 0})
            assert sorted(specials[s].tolist()) == py_special
    assert steps > 3
