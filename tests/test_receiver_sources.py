"""Receiver-source integration on loopback: Songcast sender -> receiver
source -> pipeline; SCD; RAOP session push; UpnpAv external control
(reference TestMediaPlayer/TestUdpServer style, all one process)."""

import time

import numpy as np
import pytest

from ohpipeline_jax.av.receiver_sources import (SourceRaop, SourceReceiver,
                                                SourceScd, SourceUpnpAv)
from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
from ohpipeline_jax.pipeline.manager import PipelineInitParams


def make_manager():
    p = PipelineInitParams()
    p.gorge_jiffies = 0
    p.threaded_starvation_ramper = False
    return PipelineManager(p)


def collect_until(mgr, min_samples, timeout=10.0):
    chunks = []
    deadline = time.time() + timeout

    class Animator(AnimatorBatch):
        pass

    import threading
    total = [0]
    done = threading.Event()

    def sink(s, info):
        chunks.append(s)
        total[0] += s.shape[1]
        if total[0] >= min_samples:
            done.set()

    an = AnimatorBatch(mgr.pipeline.predriver, sink, use_device=False)
    t = threading.Thread(target=lambda: an.run(stop_on_halt=False),
                         daemon=True)
    t.start()
    done.wait(timeout)
    an.quit()
    mgr.quit()
    t.join(2.0)
    return (np.concatenate(chunks, axis=1) if chunks
            else np.zeros((2, 0), np.int32))


def tone(n=1024):
    t = np.arange(n) / 44100
    return np.tile(np.rint(np.sin(2 * np.pi * 1000 * t) * 10000)
                   .astype(np.int32), (2, 1))


class TestSongcastSource:
    def test_ohm_loopback_to_pipeline(self):
        from ohpipeline_jax.net.songcast import OhmSender
        mgr = make_manager()
        sender = OhmSender(multicast=False)
        sender.start()
        src = SourceReceiver(mgr, multicast=False,
                             sender_endpoint=("127.0.0.1",
                                              sender.endpoint[1]))
        src.set_sender()
        src.activate()
        time.sleep(0.4)        # join propagates
        x = tone()
        for i in range(30):
            sender.send_audio(x, 44100, 16, sample_start=i * 1024)
        pcm = collect_until(mgr, 48 * 1024)
        sender.stop()
        src.deactivate()
        # the leading samples are the VariableDelay latency silence; the
        # tone must arrive intact after it (free-running animator may
        # interleave starvation silence, so count energy not position)
        nonzero = pcm[0][pcm[0] != 0].astype(np.float64)
        assert len(nonzero) >= 15000, len(nonzero)
        assert np.sqrt((nonzero ** 2).mean()) > 5000


class TestScdSource:
    def test_scd_loopback(self):
        from ohpipeline_jax.net.scd import ScdFormat, ScdSender
        mgr = make_manager()
        src = SourceScd(mgr)
        sender = ScdSender()
        src.connect("127.0.0.1", sender.port)
        time.sleep(0.3)
        sender.send_format(ScdFormat(44100, 16, 2))
        x = tone(4096)
        for _ in range(10):
            sender.send_audio(x, 16)
        pcm = collect_until(mgr, 8 * 1024)
        sender.close()
        src.deactivate()
        assert pcm.shape[1] >= 8 * 1024


class TestRaopSource:
    def test_session_push(self):
        mgr = make_manager()
        src = SourceRaop(mgr)
        src.session_start()
        x = tone(4096)
        for _ in range(8):
            src.push_audio(x)
        pcm = collect_until(mgr, 4 * 1024)
        src.session_end()
        assert pcm.shape[1] >= 4 * 1024


class TestUpnpAvSource:
    def test_external_uri_control(self):
        mgr = make_manager()
        src = SourceUpnpAv(mgr)
        src.set_uri("tone://sine.wav?pitch=500&duration=1")
        src.play()
        chunks = []
        AnimatorBatch(mgr.pipeline.predriver,
                      lambda s, i: chunks.append(s),
                      use_device=False).run()
        mgr.quit()
        pcm = np.concatenate(chunks, axis=1)
        assert pcm.shape == (2, 44100)
