"""Device-dequant AAC path: equivalence with the host-prep path (the
device path ships int16 quant + layout tables and dequantizes/M-S's in
one jit)."""

import numpy as np
import pytest

from ohpipeline_jax import native
from ohpipeline_jax.codecs import aac

pytestmark = pytest.mark.skipif(not native.have_aac_unpack(),
                                reason="native unpacker unavailable")


def _encode_tone(tmp_path, seconds=1.0, bitrate=192000):
    import pathlib
    import subprocess
    oracle = pathlib.Path(__file__).resolve().parent.parent / \
        ".oracle_build" / "aac_oracle"
    if not oracle.exists():
        pytest.skip("aac oracle not built")
    t = np.arange(int(44100 * seconds)) / 44100
    x = np.stack([np.rint(np.sin(2 * np.pi * 997 * t) * 20000),
                  np.rint(np.sin(2 * np.pi * 1009 * t) * 20000)]) \
        .astype(np.int16)
    fin = tmp_path / "in.raw"
    fout = tmp_path / "out.aac"
    np.ascontiguousarray(x.T).tofile(fin)
    subprocess.run([str(oracle), "encode", str(fin), str(fout), "44100",
                    "2", str(bitrate)], check=True)
    return fout.read_bytes()


def test_device_path_matches_host_path(tmp_path):
    data = _encode_tone(tmp_path)
    n, pos, batch = native.aac_parse_group(data, 0, channels=2,
                                           max_frames=64)
    st_fast = aac._StreamState(2)
    fast = aac.decode_group_device(batch, n, 2, st_fast)
    assert fast is not None
    st_ref = aac._StreamState(2)
    ref = aac.decode_group_arrays(batch, n, 2, st_ref)
    d = np.abs(fast.astype(np.int64) - ref)
    assert d.max() <= 1, d.max()     # float association + PNS rng order


def test_device_path_handles_exception_rows(tmp_path):
    # lower bitrate -> TNS/PNS rows exercise the side-buffer scatter
    data = _encode_tone(tmp_path, bitrate=96000)
    n, pos, batch = native.aac_parse_group(data, 0, channels=2,
                                           max_frames=64)
    st_fast = aac._StreamState(2)
    fast = aac.decode_group_device(batch, n, 2, st_fast)
    if fast is None:
        pytest.skip("group exceeded fast-path side buffer (fallback ok)")
    st_ref = aac._StreamState(2)
    ref = aac.decode_group_arrays(batch, n, 2, st_ref)
    # PNS bands are rng-order dependent between the two paths; compare
    # energy tightly and samples loosely
    df = fast.astype(np.float64)
    dr = ref.astype(np.float64)
    assert abs(np.sqrt((df ** 2).mean()) - np.sqrt((dr ** 2).mean())) < 50


def test_mono_falls_back():
    rng = np.random.default_rng(0)
    batch = dict(rate_index=4, ics=np.zeros((4, 4), np.int32),
                 cb=np.zeros((4, 128), np.int8),
                 sf=np.zeros((4, 128), np.int32),
                 quant=np.zeros((4, 1024), np.int32),
                 msmask=np.zeros((4, 128), np.uint8),
                 tnsn=np.zeros((4, 8), np.int32),
                 tnsp=np.zeros((4, 24, 3), np.int32),
                 tnsc=np.zeros((4, 24, 12), np.float32))
    st = aac._StreamState(1)
    assert aac.decode_group_device(batch, 4, 1, st) is None
