"""Generic rtsp:// protocol against a scripted loopback RTSP server
(reference TestProtocolRtsp style): DESCRIBE/SETUP/PLAY handshake,
interleaved RTP depacketising, RTCP-channel skipping, sequence-gap
interruption, TryStop, and playing real ADTS audio through the pipeline."""

import os
import socket
import threading

import numpy as np
import pytest

from ohpipeline_jax.protocols.base import ProtocolStreamResult
from ohpipeline_jax.protocols.rtsp import (ProtocolRtsp, parse_sdp,
                                           strip_rtp)

AAC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                   "dryrun.aac")

SDP = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=test\r\n"
       "m=audio 0 RTP/AVP 96\r\n"
       "a=rtpmap:96 mpeg4-generic/44100/2\r\n"
       "a=control:track1\r\n")


class ScriptedRtspServer(threading.Thread):
    """Speaks just enough RTSP to drive ProtocolRtsp, then pushes the
    payload as interleaved RTP."""

    def __init__(self, payload: bytes, chunk=1000, drop_seq=None,
                 rtcp_every=0, delay=0.0):
        super().__init__(daemon=True)
        self.payload = payload
        self.chunk = chunk
        self.delay = delay
        self.drop_seq = drop_seq
        self.rtcp_every = rtcp_every
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.teardown_seen = threading.Event()

    def run(self):
        conn, _ = self.sock.accept()
        f = conn.makefile("rb")
        playing = False
        try:
            while True:
                req = f.readline().decode()
                if not req:
                    break
                headers = {}
                while True:
                    line = f.readline().decode()
                    if line in ("\r\n", "\n", ""):
                        break
                    k, _, v = line.partition(":")
                    headers[k.strip().lower()] = v.strip()
                method = req.split()[0]
                cseq = headers.get("cseq", "1")
                if method == "OPTIONS":
                    conn.sendall(f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                                 "Public: DESCRIBE, SETUP, PLAY\r\n\r\n"
                                 .encode())
                elif method == "DESCRIBE":
                    body = SDP.encode()
                    conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                                  "Content-Type: application/sdp\r\n"
                                  f"Content-Length: {len(body)}\r\n\r\n")
                                 .encode() + body)
                elif method == "SETUP":
                    conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                                  "Session: 12345678\r\n"
                                  "Transport: RTP/AVP/TCP;unicast;"
                                  "interleaved=0-1\r\n\r\n").encode())
                elif method == "PLAY":
                    conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                                  "Session: 12345678\r\n\r\n").encode())
                    playing = True
                    self._pump(conn)
                    # end of scripted content: half-close so the client
                    # sees EOF (live servers just keep streaming)
                    try:
                        conn.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                elif method == "TEARDOWN":
                    self.teardown_seen.set()
                    try:
                        conn.sendall((f"RTSP/1.0 200 OK\r\n"
                                      f"CSeq: {cseq}\r\n\r\n").encode())
                    except OSError:
                        pass
                    break
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _pump(self, conn):
        import time as _time
        seq = 100
        ts = 0
        for i, off in enumerate(range(0, len(self.payload), self.chunk)):
            if self.delay:
                _time.sleep(self.delay)
            if self.rtcp_every and i % self.rtcp_every == 1:
                rtcp = b"\x80\xc8" + bytes(10)     # minimal SR on ch 1
                conn.sendall(b"$\x01" + len(rtcp).to_bytes(2, "big")
                             + rtcp)
            if self.drop_seq is not None and seq == self.drop_seq:
                seq += 1        # simulated loss
                continue
            data = self.payload[off:off + self.chunk]
            rtp = (bytes([0x80, 0x60]) + seq.to_bytes(2, "big")
                   + ts.to_bytes(4, "big") + b"\x00\x00\x00\x01" + data)
            conn.sendall(b"$\x00" + len(rtp).to_bytes(2, "big") + rtp)
            seq = (seq + 1) & 0xFFFF
            ts += 1024


class CollectingSupply:
    def __init__(self):
        self.events = []

    def output_stream(self, info, stream_handler=None):
        self.events.append(("stream", info))

    def output_data(self, data):
        self.events.append(("data", bytes(data)))

    def output_stream_interrupted(self):
        self.events.append(("interrupted", None))

    def output_flush(self, fid):
        self.events.append(("flush", fid))

    def flush_pending(self):
        pass


def test_sdp_parse():
    s = parse_sdp(SDP)
    assert s["media"] == "audio" and s["payload_type"] == 96
    assert s["encoding"] == "mpeg4-generic"
    assert s["rate"] == 44100 and s["channels"] == 2
    assert s["control"] == "track1"


def test_rtp_strip_padding_and_csrc():
    base = bytes([0x80, 0x60]) + (7).to_bytes(2, "big") + bytes(8)
    seq, payload = strip_rtp(base + b"hello")
    assert seq == 7 and payload == b"hello"
    padded = bytes([0xA0, 0x60]) + (8).to_bytes(2, "big") + bytes(8) \
        + b"hi\x00\x00\x03"
    _, payload = strip_rtp(padded)
    assert payload == b"hi"


def _stream(payload, **server_kw):
    srv = ScriptedRtspServer(payload, **server_kw)
    srv.start()
    proto = ProtocolRtsp()
    supply = CollectingSupply()
    proto.initialise(supply, None)
    res = proto.stream(f"rtsp://127.0.0.1:{srv.port}/radio")
    return res, supply, srv


def test_stream_delivers_payload():
    payload = open(AAC, "rb").read()[:20000]
    res, supply, srv = _stream(payload)
    assert res == ProtocolStreamResult.SUCCESS
    assert supply.events[0][0] == "stream"
    assert supply.events[0][1].live
    got = b"".join(d for k, d in supply.events if k == "data")
    assert got == payload
    assert srv.teardown_seen.wait(2.0)


def test_rtcp_channel_skipped_and_loss_interrupts():
    payload = bytes(range(256)) * 40
    res, supply, _ = _stream(payload, drop_seq=103, rtcp_every=3)
    assert res == ProtocolStreamResult.SUCCESS
    kinds = [k for k, _ in supply.events]
    assert "interrupted" in kinds          # the seq gap was noticed
    got = b"".join(d for k, d in supply.events if k == "data")
    # one chunk lost, the rest delivered in order
    assert len(got) == len(payload) - 1000


def test_try_stop_flushes():
    payload = bytes(1000) * 200
    srv = ScriptedRtspServer(payload, chunk=500, delay=0.01)
    srv.start()
    proto = ProtocolRtsp()
    supply = CollectingSupply()
    proto.initialise(supply, None)
    result = {}

    def run():
        result["r"] = proto.stream(f"rtsp://127.0.0.1:{srv.port}/radio")

    t = threading.Thread(target=run)
    t.start()
    import time
    for _ in range(100):
        if supply.events:
            break
        time.sleep(0.01)
    sid = supply.events[0][1].stream_id
    fid = proto.try_stop(sid)
    t.join(5)
    assert not t.is_alive()
    assert result["r"] == ProtocolStreamResult.STOPPED
    assert ("flush", fid) in supply.events


def test_plays_adts_through_pipeline():
    from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    payload = open(AAC, "rb").read()
    srv = ScriptedRtspServer(payload)
    srv.start()
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    mgr = PipelineManager(params)
    chunks = []
    mgr.play_uri(f"rtsp://127.0.0.1:{srv.port}/radio")
    animator = AnimatorBatch(mgr.pipeline.predriver,
                             lambda s, i: chunks.append((s, i)),
                             use_device=False)
    animator.run()
    mgr.quit()
    assert chunks, "no audio decoded from the RTSP stream"
    assert chunks[0][1].codec_name == "AAC"
    pcm = np.concatenate([c for c, _ in chunks], axis=1)
    assert pcm.shape[0] == 2 and pcm.shape[1] > 40000
