"""ProtocolHttp range-seek semantics against a scripted local server
(reference TestProtocolHttp style): a server that ignores Range must fail
the seek instead of silently restarting decode from byte 0."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ohpipeline_jax.protocols.base import ProtocolStreamResult
from ohpipeline_jax.protocols.http import ProtocolHttp

BODY = bytes(range(256)) * 64          # 16 KiB


class CollectingSupply:
    def __init__(self):
        self.events = []

    def output_stream(self, info, stream_handler=None):
        self.events.append(("stream", info))
        self.handler = stream_handler

    def output_data(self, data):
        self.events.append(("data", data))

    def output_metadata(self, text):
        self.events.append(("meta", text))

    def output_flush(self, fid):
        self.events.append(("flush", fid))

    def output_stream_interrupted(self):
        self.events.append(("interrupted", None))

    def flush_pending(self):
        pass


def _make_server(honour_range: bool):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            rng = self.headers.get("Range")
            if rng and honour_range:
                start = int(rng.split("=")[1].split("-")[0])
                body = BODY[start:]
                self.send_response(206)
                self.send_header(
                    "Content-Range",
                    f"bytes {start}-{len(BODY) - 1}/{len(BODY)}")
            else:
                body = BODY                 # ignores Range: full 200
                self.send_response(200)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            # trickle so the test can inject a seek mid-stream
            self.wfile.write(body[:1024])
            self.wfile.flush()
            time.sleep(0.05)
            self.wfile.write(body[1024:])

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _run_with_seek(honour_range: bool):
    srv = _make_server(honour_range)
    try:
        proto = ProtocolHttp()
        supply = CollectingSupply()
        proto.initialise(supply, None)
        uri = f"http://127.0.0.1:{srv.server_address[1]}/track.bin"
        result = {}

        def run():
            result["r"] = proto.stream(uri)

        t = threading.Thread(target=run)
        t.start()
        # wait for the stream to register, then seek
        for _ in range(100):
            if supply.events and supply.events[0][0] == "stream":
                break
            time.sleep(0.01)
        sid = supply.events[0][1].stream_id
        fid = proto.try_seek(sid, 4096)
        t.join(timeout=10)
        assert not t.is_alive()
        return result["r"], fid, supply
    finally:
        srv.shutdown()


def test_seek_succeeds_on_206():
    r, fid, supply = _run_with_seek(honour_range=True)
    assert r == ProtocolStreamResult.SUCCESS
    assert ("flush", fid) in supply.events
    # data after the flush must start at the seek offset
    i = supply.events.index(("flush", fid))
    post = b"".join(d for k, d in supply.events[i:] if k == "data")
    assert post[:16] == BODY[4096:4112]


def test_seek_fails_when_server_ignores_range():
    r, fid, supply = _run_with_seek(honour_range=False)
    assert fid > 0                      # seek was accepted upstream...
    assert r == ProtocolStreamResult.ERROR_RECOVERABLE  # ...but then failed
    # and crucially no post-flush data pretending to be at the offset
    assert ("flush", fid) not in supply.events
