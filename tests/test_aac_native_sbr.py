"""Native HE-AAC group parse (aac_parse_group_sbr) vs the Python parser.

The C++ unpacker's SBR variant must produce bit-identical frames —
including the EXT_SBR_DATA fill payload triple — and the codec must
produce identical PCM with the native parse on or off (the reference
feeds the same fill payloads to libSBRdec either way:
thirdparty/fdk-aac/libAACdec/src/aacdecoder.cpp CAacDecoder_DecodeFrame).
Uses the checked-in tests/assets/dryrun_he.aac so no oracle is needed.
"""

import os

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs.aac import (CodecAacAdts, bitstream as BS,
                                       frames_from_arrays)
from ohpipeline_jax.codecs.base import EndOfStream, StreamReader

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "assets", "dryrun_he.aac")

pytestmark = pytest.mark.skipif(not native.have_aac_unpack(),
                                reason="native aac unpacker unavailable")


class _MemReader(StreamReader):
    def __init__(self, b: bytes):
        self._b, self._p = b, 0

    def read(self, n):
        out = self._b[self._p:self._p + n]
        self._p += len(out)
        return out

    def peek(self, n):
        return self._b[self._p:self._p + n]

    @property
    def stream_bytes(self):
        return len(self._b)


def _python_frames(data: bytes):
    frames, pos = [], 0
    while pos < len(data):
        h = BS.parse_adts_header(data, pos)
        if h is None:
            break
        br = BS.BitReader(data, (pos + h.header_bytes) * 8)
        frames.append(BS.parse_raw_data_block(br, h.rate_index))
        pos += h.frame_bytes
    return frames


def _native_frames(data: bytes, channels: int):
    frames, bpos = [], 0
    while True:
        n, bpos, batch = native.aac_parse_group_sbr(
            data, bpos, channels=channels, max_frames=32)
        if n == 0:
            break
        fr = frames_from_arrays(batch, n, channels)
        for f in range(n):
            fr[f].sbr = batch["sbr"][f]
        frames.extend(fr)
    return frames


def test_parse_group_sbr_bit_identical():
    data = open(ASSET, "rb").read()
    h = BS.parse_adts_header(data)
    pyf = _python_frames(data)
    natf = _native_frames(data, h.channels)
    assert len(pyf) == len(natf) > 20
    n_sbr = 0
    for i, (a, b) in enumerate(zip(pyf, natf)):
        assert a.sbr == b.sbr, i
        n_sbr += a.sbr is not None
        assert a.rate_index == b.rate_index
        for ca, cb in zip(a.channels, b.channels):
            ia, ib = ca.ics, cb.ics
            assert (ia.window_sequence, ia.window_shape, ia.max_sfb,
                    ia.scale_factor_grouping) == \
                (ib.window_sequence, ib.window_shape, ib.max_sfb,
                 ib.scale_factor_grouping), i
            assert np.array_equal(ca.quant, cb.quant), i
            ng, ms = len(ia.window_groups()), ia.max_sfb
            assert np.array_equal(ca.band_cb[:ng, :ms],
                                  cb.band_cb[:ng, :ms]), i
            assert np.array_equal(ca.scalefactors[:ng, :ms],
                                  cb.scalefactors[:ng, :ms]), i
        if a.ms_mask is None:
            assert b.ms_mask is None, i
        else:
            assert np.array_equal(a.ms_mask, b.ms_mask), i
    assert n_sbr == len(pyf)          # every frame carries SBR data


def test_codec_pcm_identical_native_vs_python():
    data = open(ASSET, "rb").read()

    def run(use_native):
        c = CodecAacAdts(use_native=use_native)
        rdr = _MemReader(data)
        info = c.stream_initialise(rdr)
        outs = []
        try:
            while True:
                outs.append(c.process(rdr).resolve())
        except EndOfStream:
            pass
        return np.concatenate(outs, axis=1), info

    a, ia = run(False)
    b, ib = run(True)
    assert ia.codec_name == ib.codec_name == "HE-AAC"
    assert a.shape == b.shape
    # the native path preps spectra vectorized from the dense arrays
    # (prepare_group: native TNS, batched dequant) while the Python
    # path dequantizes per frame — summation order differs, so the
    # int16 rounding boundary can move by one
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
