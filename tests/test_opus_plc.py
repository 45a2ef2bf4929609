"""Opus packet-loss concealment + in-band FEC vs the reference decoder.

SILK loss/FEC runs the fixed-point pipeline (silk/PLC.c, CNG.c via
native silk_core.cc) and must be BIT-EXACT against opus_decode with
NULL/FEC calls (oracle decode's loss_spec argument).  CELT loss runs the
float reformulation of celt_decode_lost and is SNR-bounded."""

import os
import subprocess
import tempfile

import numpy as np
import pytest

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".oracle_build", "opus_oracle")

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="opus oracle not built")


class _R:
    def __init__(self, b):
        self._b, self._p = b, 0

    def read(self, n):
        out = self._b[self._p:self._p + n]
        self._p += len(out)
        return out

    def peek(self, n):
        return self._b[self._p:self._p + n]


def _encode(mode_args, kind="speech", ch=1, secs=2.0):
    t = np.arange(int(48000 * secs)) / 48000.0
    rng = np.random.default_rng(5)
    if kind == "speech":
        x = (np.sin(2 * np.pi * 220 * t)
             * (0.5 + 0.3 * np.sin(2 * np.pi * 3 * t)) * 12000
             + rng.standard_normal(len(t)) * 300)
    else:
        x = (np.sin(2 * np.pi * 523 * t) * 9000
             + np.sin(2 * np.pi * 3200 * t) * 2500
             + rng.standard_normal(len(t)) * 800)
    if ch == 2:
        x = np.stack([x, np.roll(x, 31)]).T.ravel()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.raw")
        fout = os.path.join(td, "o.opus")
        np.clip(x, -32000, 32000).astype(np.int16).tofile(fin)
        subprocess.run([ORACLE, "encode", fin, fout, *mode_args],
                       check=True, capture_output=True)
        return open(fout, "rb").read()


def _oracle_decode(data: bytes, loss: str, ch: int) -> np.ndarray:
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "i.opus")
        fo = os.path.join(td, "o.raw")
        open(fin, "wb").write(data)
        subprocess.run([ORACLE, "decode", fin, fo, loss], check=True,
                       capture_output=True)
        return np.fromfile(fo, np.int16).reshape(-1, ch).T \
            .astype(np.float64)


def _my_decode(data: bytes, lost: set, fec: set) -> np.ndarray:
    from ohpipeline_jax.codecs.opus import _OpusStream, parse_opus_head
    from ohpipeline_jax.containers.ogg import OggReader
    pkts = list(OggReader(_R(data)).packets())
    head = parse_opus_head(pkts[0])
    st = _OpusStream(head)
    outs = []
    for i, p in enumerate(pkts[2:]):
        p = bytes(p)
        if i in lost:
            outs.append(st.conceal_packet(20))
        elif i in fec:
            outs.append(st.decode_packet_fec(p))
            outs.append(st.decode_packet(p))
        else:
            outs.append(st.decode_packet(p))
    mine = np.concatenate(outs, axis=1) * 32768.0
    return mine[:, head.pre_skip:]


def _fix_active() -> bool:
    from ohpipeline_jax.codecs.opus.silk import _have_fix
    return _have_fix()


@pytest.mark.parametrize("loss", ["20,41,42", "5,6,7,8,60"])
def test_silk_plc_bit_exact(loss):
    """Lost SILK packets reconstruct bit-exactly: LPC/LTP
    extrapolation, attenuation ladder, CNG and the recovery frame's
    bandwidth expansion + glue fade all match silk/PLC.c + CNG.c."""
    if not _fix_active():
        pytest.skip("native silk core unavailable")
    data = _encode(("1", "24000", "silk"))
    lost = {int(x) for x in loss.split(",")}
    ref = _oracle_decode(data, loss, 1)
    mine = _my_decode(data, lost, set())
    m = min(mine.shape[1], ref.shape[1])
    assert np.array_equal(np.rint(mine[:, :m]), ref[:, :m])


def test_silk_fec_bit_exact():
    """A lost packet recovered from the next packet's LBRR data
    (opus_decode decode_fec=1) is bit-exact, including the state
    handoff into the following normal decode."""
    if not _fix_active():
        pytest.skip("native silk core unavailable")
    data = _encode(("1", "24000", "silkfec"))
    ref = _oracle_decode(data, "f30", 1)
    mine = _my_decode(data, set(), {30})
    m = min(mine.shape[1], ref.shape[1])
    assert np.array_equal(np.rint(mine[:, :m]), ref[:, :m])


def test_celt_plc_bounded():
    """CELT packet loss: pitch-based extrapolation tracks
    celt_decode_lost within float tolerances — concealed frames >=
    55 dB, recovery frames >= 60 dB (the out-of-place
    prefilter_and_fold comb matters: in-place filtering cost ~40 dB
    on the recovery frame), clean frames unaffected."""
    data = _encode(("2", "96000", "celt"), kind="music", ch=2)
    lost = {20, 41, 42}
    ref = _oracle_decode(data, "20,41,42", 2)
    mine = _my_decode(data, lost, set())
    m = min(mine.shape[1], ref.shape[1])
    a, b = mine[:, :m], ref[:, :m]
    pre = 312
    for i in range(10, 48):
        s, e = i * 960 - pre, (i + 1) * 960 - pre
        if s < 0 or e > m:
            continue
        err = a[:, s:e] - b[:, s:e]
        snr = 10 * np.log10(max((b[:, s:e] ** 2).sum(), 1e-9)
                            / max((err ** 2).sum(), 1e-9))
        recovery = (i - 1 in lost) or (i - 2 in lost)
        if i in lost:
            assert snr >= 55.0, f"concealed pkt {i}: {snr:.1f} dB"
        elif recovery:
            assert snr >= 60.0, f"recovery pkt {i}: {snr:.1f} dB"
        else:
            assert snr >= 60.0, f"clean pkt {i}: {snr:.1f} dB"


def test_silk_stereo_plc_bounded():
    """Stereo SILK loss: both cores conceal, MS->LR uses the previous
    predictors; output stays close to the reference's (the mid/side
    PLC interplay keeps it bit-exact on the fixed path)."""
    if not _fix_active():
        pytest.skip("native silk core unavailable")
    data = _encode(("2", "48000", "silk"), ch=2)
    lost = {25, 26}
    ref = _oracle_decode(data, "25,26", 2)
    mine = _my_decode(data, lost, set())
    m = min(mine.shape[1], ref.shape[1])
    err = np.rint(mine[:, :m]) - ref[:, :m]
    if np.abs(err).max() == 0:
        return                     # bit-exact
    snr = 10 * np.log10((ref[:, :m] ** 2).sum()
                        / max((err ** 2).sum(), 1e-9))
    assert snr >= 40.0, f"stereo PLC SNR {snr:.1f} dB"
