"""The port's Ollama client (``engine/ollama_client.py``) against the JAX
package's, through a stub of ``/api/chat`` on localhost that records every
request: equal payload dicts for equal calls (free text with streaming on
and off, schema calls with ``format`` and no streaming, an empty system
prompt, ``think``), the same assembled text and echo from an NDJSON
stream, the ``OLLAMA_HOST`` rule, the defaults and the timeout."""

import http.server
import json
import socket
import threading
import time
import urllib.error

import pytest

from handwritten_ocr_tpu.engine.ollama_client import (
    OllamaBackend as JaxOllamaBackend)
from handwritten_ocr_tpu_torch.engine.ollama_client import OllamaBackend

SCHEMA = {"type": "object", "properties": {"verdict": {"type": "string"}},
          "required": ["verdict"]}


def _answer(body: dict) -> str:
    user = body["messages"][-1]["content"]
    if body.get("format") is not None:
        return json.dumps({"verdict": "accept", "echo": user})
    return f"answer to {user} ✓ with {len(body['messages'])} messages"


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.requests.append(
            (self.path, self.headers["Content-Type"], body))
        if body["messages"][-1]["content"] == "slow":
            time.sleep(2.0)      # the client has given up: nothing to send
            return
        text = self.server.answer(body)
        if body["stream"]:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            for i in range(0, len(text), 5):
                part = {"message": {"role": "assistant",
                                    "content": text[i:i + 5]}, "done": False}
                self.wfile.write(json.dumps(part).encode() + b"\n\n")
            self.wfile.write(json.dumps({"message": {"role": "assistant",
                                                     "content": ""},
                                         "done": True}).encode() + b"\n")
            return
        data = json.dumps({"message": {"role": "assistant", "content": text},
                           "done": True}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture
def stub():
    """A threaded ``/api/chat`` server on 127.0.0.1 that records every
    request and answers with ``server.answer(body)``: NDJSON when the
    request streams, one JSON body otherwise."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.daemon_threads = True
    server.requests = []
    server.answer = _answer          # a test may answer otherwise
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


CALLS = [
    ("You are a critic.", "Check: teh cat", dict(temperature=0.1,
                                                 max_tokens=64)),
    ("", "no system prompt", dict(temperature=0.0, max_tokens=8)),
    ("sys", "schema call", dict(temperature=0.1, max_tokens=32,
                                json_schema=SCHEMA)),
    ("ünïcödé", "multi\nline\t\"quoted\"", dict(temperature=0.7,
                                                max_tokens=1,
                                                json_schema=None)),
    ("", "schema, no system", dict(temperature=0.2, max_tokens=16,
                                   json_schema={"type": "object"})),
]


def _run(cls, host, server, **kwargs):
    client = cls(host=host, **kwargs)
    start = len(server.requests)
    texts = [client.chat(system, user, **call) for system, user, call in CALLS]
    return texts, server.requests[start:]


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("think", [False, True])
def test_payloads_and_answers_equal_jax(stub, stream, think, capsys):
    server, url = stub
    got = _run(OllamaBackend, url, server, stream=stream, think=think,
               model="m:1")
    port_echo = capsys.readouterr().out
    want = _run(JaxOllamaBackend, url, server, stream=stream, think=think,
                model="m:1")
    assert got == want
    assert capsys.readouterr().out == port_echo
    texts, requests = got
    for (system, user, call), text, (path, kind, body) in zip(
            CALLS, texts, requests):
        schema = call.get("json_schema")
        assert path == "/api/chat" and kind == "application/json"
        assert body["stream"] is (stream and schema is None)
        assert ("format" in body) is (schema is not None)
        assert [m["role"] for m in body["messages"]] == \
            (["system"] if system else []) + ["user"]
        assert body["think"] is think and body["model"] == "m:1"
        assert body["options"] == {"temperature": call["temperature"],
                                   "num_predict": call["max_tokens"]}
        assert text == _answer(body)
    streamed = [t for t, (_, _, b) in zip(texts, requests) if b["stream"]]
    assert port_echo == "".join(t + "\n" for t in streamed)


def test_defaults_equal_jax(monkeypatch):
    monkeypatch.delenv("OLLAMA_HOST", raising=False)
    port, ref = OllamaBackend(), JaxOllamaBackend()
    assert vars(port) == vars(ref)
    assert port.host == "http://localhost:11434"
    assert (port.model, port.timeout, port.think, port.stream) == (
        "qwen3:32b", 300, False, True)


def test_ollama_host_rule(stub, monkeypatch):
    server, url = stub
    monkeypatch.setenv("OLLAMA_HOST", url + "/")
    port, ref = OllamaBackend(stream=False), JaxOllamaBackend(stream=False)
    assert port.host == ref.host == url
    assert port.chat("", "via env", temperature=0.1, max_tokens=4) == \
        ref.chat("", "via env", temperature=0.1, max_tokens=4)
    assert len(server.requests) == 2
    explicit = OllamaBackend(host="http://127.0.0.1:1/")
    assert explicit.host == JaxOllamaBackend(host="http://127.0.0.1:1/").host \
        == "http://127.0.0.1:1"


@pytest.mark.parametrize("cls", [OllamaBackend, JaxOllamaBackend])
def test_timeout_reaches_the_request(stub, cls):
    server, url = stub
    client = cls(host=url, timeout=0.5, stream=False)
    t0 = time.perf_counter()
    with pytest.raises((socket.timeout, TimeoutError, urllib.error.URLError)):
        client.chat("", "slow", temperature=0.1, max_tokens=4)
    assert time.perf_counter() - t0 < 1.9
