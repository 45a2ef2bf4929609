"""Bit-exact validation of the fixed-point SBR transposer LPC
transcription (codecs/aac/sbr_fixlpc.py) against fdk's own arithmetic.

Builds an instrumented oracle (tools/build_instr_lpc.py — a patched
lpp_tran.cpp that dumps every lppTransposer call's alphas and scaled
int32 inputs), decodes HE-AAC noise content, and replays every
(call, band) through fix_alphas_bands: the raw FIXP_SGL alpha words and
the reset flags must match fdk exactly.

Reference behaviour: fdk-aac/libFDK/src/autocorr2nd.cpp:185-280,
libSBRdec/src/lpp_tran.cpp:371-560, libFDK/src/fixpoint_math.cpp
(fDivNorm/schur_div).
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, ".oracle_build", "aac_oracle")
INSTR = os.path.join(REPO, ".oracle_build", "aac_oracle_instr")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="aac oracle not built")


def _ensure_instr():
    if os.path.exists(INSTR):
        return True
    try:
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "build_instr_lpc.py")],
                       check=True, capture_output=True, timeout=600)
    except Exception:                                     # noqa: BLE001
        return False
    return os.path.exists(INSTR)


def test_fix_alphas_bit_exact_vs_fdk():
    if not _ensure_instr():
        pytest.skip("instrumented oracle not buildable")
    from ohpipeline_jax.codecs.aac.sbr_fixlpc import fix_alphas_bands
    rng = np.random.default_rng(7)
    x = np.clip(rng.standard_normal(int(44100 * 1.2)) * 4000,
                -32000, 32000).astype(np.int16)
    pcm = np.stack([x, x]).T.copy()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.aac")
        fdec = os.path.join(td, "d.raw")
        dump = os.path.join(td, "lpc.txt")
        pcm.tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, "44100", "2",
                        "48000", "2", "5"], check=True,
                       capture_output=True)
        env = dict(os.environ, SBR_LPC_DUMP=dump)
        subprocess.run([INSTR, "decode", fout, fdec], check=True,
                       capture_output=True, env=env)
        rows = []
        for line in open(dump):
            p = line.split()
            if p[0] == "A":
                a = [int(v) for v in p[3:7]]
                meta = (int(p[7]), int(p[8]), int(p[11]))
                rows.append([a, meta, None])
            elif p[0] == "X" and rows:
                v = np.array([int(q) for q in p[3:]], np.int64)
                rows[-1][2] = (v[0::2], v[1::2])
    rows = [r for r in rows if r[2] is not None]
    assert len(rows) > 500
    zr = np.stack([r[2][0] for r in rows])
    zi = np.stack([r[2][1] for r in rows])
    com_dyn = np.array([r[1][2] + r[1][1] for r in rows], np.int64)
    a0r, a0i, a1r, a1i, reset = fix_alphas_bands(zr, zi, com_dyn)
    want = np.array([r[0] for r in rows], np.int64)
    want_reset = np.array([r[1][0] for r in rows], bool)
    got = np.stack([a0r, a0i, a1r, a1i], axis=1)
    exact = (got == want).all(axis=1) & (reset == want_reset)
    assert exact.all(), (
        f"{(~exact).sum()}/{len(rows)} (call,band) pairs mismatch "
        f"fdk's fixed-point alphas")
