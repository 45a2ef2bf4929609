"""RAAT source against a mock Roon peer (reference Av/Raat/ tested
without the proprietary SDK): push PCM and DSD through ProtocolRaat into
the pipeline, DSD block chunking + silence padding, transport and volume
bridges."""

import threading
import time

import numpy as np
import pytest

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.av.raat import (DSD_BLOCK_BYTES, DSD_SILENCE,
                                    ProtocolRaat, RaatStreamFormat,
                                    RaatVolumeBridge, SourceRaat)
from ohpipeline_jax.av.volume import VolumeManager, VolumeProfile
from ohpipeline_jax.core.streaminfo import AudioFormat
from ohpipeline_jax.ops.pcm import pack_pcm_bytes
from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
from ohpipeline_jax.pipeline.manager import PipelineInitParams


class MockRaatPeer:
    """The IRaatReader shape (Output.h:42-50): the SDK-side object the
    protocol pulls from."""

    def __init__(self, fmt: RaatStreamFormat, chunks: list[bytes],
                 delay: float = 0.0):
        self.fmt = fmt
        self.chunks = list(chunks)
        self.ready = threading.Event()
        self.interrupted = False
        self.delay = delay

    def stream_format(self) -> RaatStreamFormat:
        return self.fmt

    def notify_ready(self) -> None:
        self.ready.set()

    def read(self, writer) -> bool:
        if self.delay:
            time.sleep(self.delay)
        if self.interrupted or not self.chunks:
            return False
        writer.write(self.chunks.pop(0))
        return True

    def interrupt(self) -> None:
        self.interrupted = True


def make_pipeline():
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    return PipelineManager(params)


def test_pcm_push_end_to_end():
    mgr = make_pipeline()
    rate = 44100
    t = np.arange(rate) / rate
    tone = np.tile(np.rint(20000 * np.sin(2 * np.pi * 499 * t))
                   .astype(np.int32), (2, 1))
    data = pack_pcm_bytes(tone, 16, big_endian=True)
    chunks = [data[i:i + 8192] for i in range(0, len(data), 8192)]
    peer = MockRaatPeer(RaatStreamFormat(), chunks)
    src = SourceRaat(mgr, peer)
    src.activate(auto_play=True)
    got = []
    animator = AnimatorBatch(mgr.pipeline.predriver,
                             lambda s, i: got.append((s, i)),
                             use_device=False)
    animator.run()
    mgr.quit()
    assert peer.ready.is_set()
    assert got and got[0][1].codec_name == "RAAT"
    pcm = np.concatenate([s for s, _ in got], axis=1)
    # the protocol announces the RAAT latency (150 ms): the variable
    # delay inserts leading silence before the pushed audio
    nz = np.nonzero(pcm[0])[0]
    assert len(nz), "all silence"
    start = nz[0] - np.nonzero(tone[0])[0][0]
    np.testing.assert_array_equal(pcm[:, start:start + tone.shape[1]],
                                  tone)


def test_dsd_chunking_and_silence_padding():
    # 2-channel DSD: blocks are DSD_BLOCK_BYTES*2 = 8 bytes; feed an
    # amount that is NOT block-aligned and check padding on flush
    payload = bytes(range(1, 21))            # 20 bytes: 2 blocks + 4 left
    fmt = RaatStreamFormat(audio_format=AudioFormat.DSD,
                           sample_rate=2_822_400, bit_depth=1,
                           num_channels=2)
    peer = MockRaatPeer(fmt, [payload[:6], payload[6:20]])
    mgr = make_pipeline()
    src = SourceRaat(mgr, peer)
    src.activate(auto_play=True)
    got = []
    animator = AnimatorBatch(mgr.pipeline.predriver,
                             lambda s, i: got.append((s, i)),
                             use_device=False)
    animator.run()
    mgr.quit()
    dsd = [(s, i) for s, i in got if i.audio_format is AudioFormat.DSD]
    assert dsd, "no DSD reached the sink"
    data = np.concatenate([s for s, _ in dsd], axis=1)
    assert data.shape[0] == 2
    # CodecDsdRaw deinterleaves per block; total bytes = 24 (padded)
    assert data.shape[1] * 2 == 24
    # the flush padding arrived (2 silence bytes per channel tail)
    assert bytes(data[0][-2:]) == bytes([DSD_SILENCE]) * 2
    assert bytes(data[1][-2:]) == bytes([DSD_SILENCE]) * 2


def test_transport_bridge_controls_and_notifies():
    mgr = make_pipeline()
    seen = []
    peer = MockRaatPeer(RaatStreamFormat(), [])
    src = SourceRaat(mgr, peer, transport_notify=seen.append)
    src.activate()
    src.transport.play()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if any(s["state"] == "playing" for s in seen):
            break
        time.sleep(0.02)
    assert any(s["state"] == "playing" for s in seen)
    src.transport.pause()
    mgr.quit()


def test_volume_bridge_roundtrip():
    cm = ConfigManager()
    vm = VolumeManager(cm, VolumeProfile(max_volume=100,
                                         default_volume=40,
                                         default_limit=100))
    notified = []
    bridge = RaatVolumeBridge(vm, notify=notified.append)
    bridge.set_volume(0.66)
    assert vm.volume == 66
    assert abs(bridge.volume() - 0.66) < 1e-9
    assert notified and abs(notified[-1] - 0.66) < 1e-9
    bridge.set_mute(True)
    assert vm.muted
    bridge.set_mute(False)
    assert not vm.muted


def test_try_stop_flushes_and_interrupts_peer():
    fmt = RaatStreamFormat()
    peer = MockRaatPeer(fmt, [b"\x00\x01" * 4096] * 1000, delay=0.01)

    class Supply:
        def __init__(self):
            self.events = []

        def output_stream(self, info, stream_handler=None):
            self.events.append(("stream", info))

        def output_data(self, d):
            self.events.append(("data", bytes(d)))

        def output_delay(self, j):
            self.events.append(("delay", j))

        def output_flush(self, fid):
            self.events.append(("flush", fid))

        def flush_pending(self):
            pass

    proto = ProtocolRaat(peer)
    supply = Supply()
    proto.initialise(supply, None)
    result = {}
    t = threading.Thread(
        target=lambda: result.update(r=proto.stream("raat://raat")))
    t.start()
    for _ in range(200):
        if supply.events:
            break
        time.sleep(0.005)
    sid = supply.events[0][1].stream_id
    fid = proto.try_stop(sid)
    t.join(5)
    assert not t.is_alive()
    assert peer.interrupted
    assert ("flush", fid) in supply.events
