"""End-to-end pipeline integration (reference TestPipeline style, §4.3):
play tone:// / file:// URIs through the full element chain to a collecting
animator; assert waveform integrity (zero-crossing cadence) and state
transitions."""

import time

import numpy as np
import pytest

from ohpipeline_jax.core import events as ev
from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
from ohpipeline_jax.pipeline.manager import PipelineInitParams


class Collector:
    def __init__(self):
        self.chunks = []
        self.infos = []

    def __call__(self, samples, info):
        self.chunks.append(samples)
        self.infos.append(info)

    @property
    def pcm(self):
        return (np.concatenate(self.chunks, axis=1) if self.chunks
                else np.zeros((2, 0), np.int32))


def make_manager():
    params = PipelineInitParams()
    params.gorge_jiffies = 0           # tests want immediate flow
    params.threaded_starvation_ramper = False
    return PipelineManager(params)


def run_until_halt(mgr, collector, timeout=30.0):
    animator = AnimatorBatch(mgr.pipeline.predriver, collector,
                             use_device=False)
    animator.run()
    return animator


def zero_crossings(x):
    s = np.signbit(x.astype(np.int64))
    return int(np.count_nonzero(s[1:] != s[:-1]))


def test_tone_uri_end_to_end():
    mgr = make_manager()
    col = Collector()
    mgr.play_uri("tone://sine.wav?pitch=1000&duration=2&samplerate=44100"
                 "&bitdepth=16&channels=2")
    run_until_halt(mgr, col)
    mgr.quit()
    pcm = col.pcm
    assert pcm.shape == (2, 88200)
    zc = zero_crossings(pcm[0])
    assert abs(zc - 4000) <= 4, zc


def test_file_wav_end_to_end(tmp_path):
    from ohpipeline_jax.codecs.wav import write_wav
    t = np.arange(44100) / 44100
    tone = np.tile(np.rint(np.sin(2 * np.pi * 997 * t) * 30000)
                   .astype(np.int32), (2, 1))
    path = tmp_path / "t.wav"
    path.write_bytes(write_wav(tone, 44100, 16))
    mgr = make_manager()
    col = Collector()
    mgr.play_uri(f"file://{path}")
    run_until_halt(mgr, col)
    mgr.quit()
    np.testing.assert_array_equal(col.pcm, tone)


def test_file_flac_end_to_end(tmp_path):
    from ohpipeline_jax.codecs import flac
    t = np.arange(44100) / 44100
    tone = np.stack([np.rint(np.sin(2 * np.pi * 997 * t) * 28000),
                     np.rint(np.sin(2 * np.pi * 1009 * t) * 28000)]
                    ).astype(np.int32)
    path = tmp_path / "t.flac"
    path.write_bytes(flac.encode_flac(tone, 44100, 16))
    mgr = make_manager()
    col = Collector()
    mgr.play_uri(f"file://{path}")
    run_until_halt(mgr, col)
    mgr.quit()
    np.testing.assert_array_equal(col.pcm, tone)
    assert col.infos[0].codec_name == "FLAC"


def test_observers_receive_track_and_state():
    mgr = make_manager()
    seen = {"tracks": [], "states": [], "infos": [], "times": []}

    class Obs:
        def notify_track(self, track, sos):
            seen["tracks"].append(track.uri)

        def notify_pipeline_state(self, st):
            seen["states"].append(st)

        def notify_stream_info(self, info):
            seen["infos"].append(info)

        def notify_time(self, sec, total):
            seen["times"].append(sec)

    mgr.add_observer(Obs())
    col = Collector()
    mgr.play_uri("tone://square.wav?pitch=100&duration=2")
    run_until_halt(mgr, col)
    mgr.quit()
    assert seen["tracks"] and seen["tracks"][0].startswith("tone://")
    assert seen["infos"] and seen["infos"][0].sample_rate == 44100
    assert 1 in seen["times"]


def test_file_he_aac_end_to_end(tmp_path):
    """HE-AAC ADTS through the full chain: codec detects SBR, the stream
    plays at the doubled rate and the upper band carries energy."""
    import os
    import subprocess
    oracle = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".oracle_build", "aac_oracle")
    if not os.path.exists(oracle):
        pytest.skip("aac oracle not built")
    t = np.arange(int(44100 * 1.5)) / 44100
    tone = np.clip(np.sin(2 * np.pi * 700 * t) * 9000
                   + np.sin(2 * np.pi * 9000 * t) * 6000,
                   -32000, 32767).astype(np.int16)
    pcm_in = np.stack([tone, tone]).T.copy()
    raw = tmp_path / "i.raw"
    aac = tmp_path / "t.aac"
    pcm_in.tofile(raw)
    subprocess.run([oracle, "encode", str(raw), str(aac), "44100", "2",
                    "48000", "2", "5"], check=True, capture_output=True)
    mgr = make_manager()
    col = Collector()
    mgr.play_uri(f"file://{aac}")
    run_until_halt(mgr, col)
    mgr.quit()
    assert col.infos and col.infos[0].codec_name == "HE-AAC"
    assert col.infos[0].sample_rate == 44100
    out = col.pcm.astype(np.float64)
    assert out.shape[1] > 44100
    # the 9 kHz component (above the ~7.9 kHz crossover) must be present
    seg = out[0, 24000:24000 + 16384]
    X = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1 / 44100.0)
    hf_peak = X[(f > 8500) & (f < 9500)].max()
    lo_peak = X[(f > 600) & (f < 800)].max()
    assert hf_peak > 0.05 * lo_peak


def test_file_he_aac_v2_ps_end_to_end(tmp_path):
    """HE-AAC v2 (AOT 29: mono core + SBR + parametric stereo) through
    the full chain: the codec must force stereo output, both channels
    carry the signal, and the PS stage produces a decorrelated-but-
    coherent stereo image (finite inter-channel correlation of a mono
    downmix source)."""
    import os
    import subprocess
    oracle = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".oracle_build", "aac_oracle")
    if not os.path.exists(oracle):
        pytest.skip("aac oracle not built")
    t = np.arange(int(44100 * 1.5)) / 44100
    tone = np.clip(np.sin(2 * np.pi * 600 * t) * 9000
                   + np.sin(2 * np.pi * 8800 * t) * 5000,
                   -32000, 32767).astype(np.int16)
    pcm_in = np.stack([tone, tone]).T.copy()
    raw = tmp_path / "i.raw"
    aac = tmp_path / "t29.aac"
    pcm_in.tofile(raw)
    subprocess.run([oracle, "encode", str(raw), str(aac), "44100", "2",
                    "24000", "2", "29"], check=True, capture_output=True)
    mgr = make_manager()
    col = Collector()
    mgr.play_uri(f"file://{aac}")
    run_until_halt(mgr, col)
    mgr.quit()
    assert col.infos and col.infos[0].codec_name == "HE-AAC v2"
    assert col.infos[0].num_channels == 2
    out = col.pcm.astype(np.float64)
    assert out.shape[0] == 2 and out.shape[1] > 44100
    seg = out[:, 20000:20000 + 16384]
    rms = np.sqrt((seg ** 2).mean(axis=1))
    assert rms.min() > 200                 # both channels carry signal
    # mono source: channels stay strongly correlated through PS
    c = np.corrcoef(seg[0], seg[1])[0, 1]
    assert c > 0.5
    # SBR band present (the 8.8 kHz component sits above the crossover)
    X = np.abs(np.fft.rfft(seg[0] * np.hanning(seg.shape[1])))
    f = np.fft.rfftfreq(seg.shape[1], 1 / 44100.0)
    hf = X[(f > 8300) & (f < 9300)].max()
    lo = X[(f > 500) & (f < 700)].max()
    assert hf > 0.02 * lo
