"""Native CELT entropy core (celt_core.cc) vs the Python fallback.

The Python path in codecs/opus/celt.py is the behaviour oracle for the
C++ core (same relationship as alac_core/mp3_core to their Python
loops): all wire/integer decisions must agree bit-for-bit, and the
float spectral output must agree to ulp-level (numpy BLAS dot ordering
differs from a plain C loop in the last ulp, so exact float equality is
not required -- int16 PCM equality is).

Conformance vs the real libopus decoder is covered by
tests/test_opus_celt.py, which exercises the native path by default.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from ohpipeline_jax import native

ORACLE = pathlib.Path(__file__).resolve().parent.parent \
    / ".oracle_build" / "opus_oracle"

pytestmark = pytest.mark.skipif(
    not native.have_celt_core(), reason="native celt core unavailable")


def _encode(pcm: np.ndarray, mode: str, bitrate: int) -> bytes:
    ch = pcm.shape[0]
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.ascontiguousarray(pcm.T).tofile(fin)
        subprocess.run([str(ORACLE), "encode", fin, fout, str(ch),
                        str(bitrate), mode], check=True,
                       capture_output=True)
        return open(fout, "rb").read()


def _content(seconds: float, ch: int) -> np.ndarray:
    rate = 48000
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(7)
    x = (np.sin(2 * np.pi * 440 * t) * 8000
         + np.sin(2 * np.pi * 2900 * t) * 2500
         + rng.standard_normal(len(t)) * 700)
    x = np.clip(x, -32000, 32000)
    if ch == 2:
        return np.stack([x, np.roll(x, 17)]).astype(np.int16)
    return x[None, :].astype(np.int16)


@pytest.mark.parametrize("ch,mode,bitrate", [
    (1, "celt", 64000),
    (2, "celt", 96000),
    (1, "hybrid", 32000),
])
def test_native_matches_python_fallback(ch, mode, bitrate, monkeypatch):
    if not ORACLE.exists():
        pytest.skip("opus oracle unavailable")
    from ohpipeline_jax.codecs.opus import decode_opus
    data = _encode(_content(2.0, ch), mode, bitrate)

    monkeypatch.setenv("OHP_CELT_PY", "1")
    _, pcm_py = decode_opus(data)
    monkeypatch.delenv("OHP_CELT_PY")
    _, pcm_nat = decode_opus(data)

    assert pcm_py.shape == pcm_nat.shape
    # integer (wire) agreement is absolute: the int16 PCM must match
    np.testing.assert_array_equal(pcm_py, pcm_nat)


def test_native_entropy_layer_is_active():
    """The default decode path must actually use celt_core (no silent
    permanent fallback)."""
    from ohpipeline_jax.codecs.opus import celt as C
    assert C._use_native_celt()


def test_comb_filter_and_deemphasis_match_python():
    rng = np.random.default_rng(3)
    from ohpipeline_jax.codecs.opus import celt as C
    win = C.celt_mode().window
    x_py = rng.standard_normal(1024 + 960)
    x_nat = x_py.copy()
    # python path
    os.environ["OHP_CELT_PY"] = "1"
    try:
        C._comb_filter(x_py, 1024, 33, 245, 960, 0.18, 0.25, 0, 2,
                       win, len(win))
    finally:
        del os.environ["OHP_CELT_PY"]
    native.celt_comb_filter(x_nat, 1024, 33, 245, 960, 0.18, 0.25, 0, 2,
                            win, len(win))
    np.testing.assert_allclose(x_nat, x_py, rtol=0, atol=1e-12)

    x = rng.standard_normal(960)
    m = 0.37
    pcm_nat, m_nat = native.celt_deemphasis(x, 0.850006103515625, m)
    pcm_py = np.empty_like(x)
    mp = m
    for j in range(len(x)):
        tmp = x[j] + mp
        mp = 0.8500061035156250 * tmp
        pcm_py[j] = tmp
    np.testing.assert_array_equal(pcm_nat, pcm_py)
    assert m_nat == mp
