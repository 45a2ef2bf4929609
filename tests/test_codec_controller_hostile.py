"""CodecController survival on hostile codecs/streams: an UNEXPECTED
exception out of a codec (not the typed CodecStreamCorrupt/EndOfStream)
must be treated as stream corruption — StreamInterrupted emitted, codec
dropped, the pipeline keeps flowing.  The reference's contract is that
invalid codec files are rejected without crash
(/root/reference/OpenHome/Media/Tests/TestCodecInit.cpp:81-82, run
under valgrind on every commit)."""

import numpy as np

from ohpipeline_jax.codecs.base import (CodecBase, CodecRegistry,
                                        DecodedBatch, EndOfStream)
from ohpipeline_jax.core import events as ev
from ohpipeline_jax.core.streaminfo import EncodedStreamInfo, PcmStreamInfo
from ohpipeline_jax.pipeline.codec_controller import CodecController


class _NoContainers:
    def process(self, reader):
        return reader, {}


class _Upstream:
    def __init__(self, events):
        self._events = list(events)

    def pull(self):
        if self._events:
            return self._events.pop(0)
        return ev.HaltEvent()


class _BlowsUpMidStream(CodecBase):
    """Recognises anything; emits one good batch, then raises an
    unexpected (untyped) error — e.g. a parser bug on hostile input."""

    name = "boom"
    recognition_cost = 1

    def __init__(self):
        self._calls = 0

    def recognise(self, header: bytes) -> bool:
        return True

    def stream_initialise(self, reader):
        reader.read(4)
        return PcmStreamInfo(44100, 16, 2, codec_name="boom")

    def process(self, reader):
        self._calls += 1
        if self._calls == 1:
            return DecodedBatch(
                PcmStreamInfo(44100, 16, 2, codec_name="boom"),
                samples=np.ones((2, 64), np.int32),
                track_offset_samples=0)
        raise RuntimeError("decoder bug on hostile input")


class _BlowsUpAtInit(_BlowsUpMidStream):
    def stream_initialise(self, reader):
        raise KeyError("unexpected at init")


def _registry(factory):
    reg = CodecRegistry()
    reg.add(factory)
    return reg


def _stream_events():
    return [
        ev.EncodedStreamEvent(EncodedStreamInfo(uri="hostile://x")),
        ev.EncodedAudioEvent(b"\x00" * 4096),
        ev.EncodedAudioEvent(b"\x00" * 4096),
    ]


def test_unexpected_process_error_interrupts_not_crashes():
    cc = CodecController(_Upstream(_stream_events()),
                         _registry(_BlowsUpMidStream),
                         containers=_NoContainers())
    kinds = [cc.pull().kind for _ in range(8)]
    assert "decoded_stream" in kinds
    assert "audio_pcm" in kinds            # the good batch got through
    i = kinds.index("stream_interrupted")  # then corruption, no raise
    # the chain keeps flowing after the interruption
    assert "halt" in kinds[i:]


def test_unexpected_init_error_interrupts_not_crashes():
    cc = CodecController(_Upstream(_stream_events()),
                         _registry(_BlowsUpAtInit),
                         containers=_NoContainers())
    kinds = [cc.pull().kind for _ in range(6)]
    assert "stream_interrupted" in kinds
    assert "decoded_stream" not in kinds
    assert "halt" in kinds


def test_deferred_batch_error_interrupts_not_crashes():
    """The deferred (lazy-resolve) decode path raises at resolve time —
    still inside the controller's protection."""

    class _BlowsUpInDefer(_BlowsUpMidStream):
        def process(self, reader):
            self._calls += 1
            if self._calls == 1:
                def boom():
                    raise ValueError("lazy decode bug")
                return DecodedBatch(
                    PcmStreamInfo(44100, 16, 2, codec_name="boom"),
                    defer=boom, track_offset_samples=0)
            raise EndOfStream

    cc = CodecController(_Upstream(_stream_events()),
                         _registry(_BlowsUpInDefer),
                         containers=_NoContainers())
    kinds = [cc.pull().kind for _ in range(6)]
    assert "stream_interrupted" in kinds
    assert "halt" in kinds
