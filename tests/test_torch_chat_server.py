"""The port's OpenAI-style chat server (vlaser_tpu_torch/serve/chat_server.py)
over the port's backends (inference/chat.VlaserChat, serve/engine_chat
.EngineChat) on tiny_vlm at fp32, against the JAX package's server: the
five JAX server tests (tests/test_serving_and_export.py: roundtrip,
concurrent batching, the stream shim, engine streaming, max_tokens and
multi-image messages), `_parse_messages` on the same messages in both
packages (tiles bit-equal), the two servers answering alike over the same
weights, the held-back UTF-8 of SSE deltas, 500 on a backend failure and
no autograd graph in the server's threads. Requests go over real sockets
on 127.0.0.1."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.inference.chat import VlaserChat as JaxChat
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu.serve import chat_server as jserver
from vlaser_tpu.serve.engine_chat import EngineChat as JaxEngineChat
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.serve import chat_server
from vlaser_tpu_torch.serve.chat_server import (ChatHTTPServer,
                                                _parse_messages,
                                                chat_completion_request)
from vlaser_tpu_torch.serve.engine_chat import EngineChat
from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
from vlaser_tpu_torch.utils.convert import from_jax_variables


class _Tok:
    """The JAX server tests' tokenizer: one id a character, EOS 3, one
    decimal id a decoded token (token counts readable from the text)."""

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [7 + (ord(c) % 89) for c in text[:24]]}

    def convert_tokens_to_ids(self, t):
        return 3

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """-> (cfg, JAX model, JAX variables, port model): tiny_vlm, fp32."""
    cfg = tiny_vlm()
    jm = JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(13)
    ids = rng.integers(1, 400, (1, 8))
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(px),
                None)
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return cfg, jm, v, tm


def _data_url(rng, side=64):
    im = Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8),
                         "RGB")
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/v1/chat/completions", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers["Content-Type"]
        body = r.read().decode()
    if ctype == "text/event-stream":
        return [e for e in body.split("\n\n") if e]
    return json.loads(body)


def _serving(srv):
    srv.start_background()
    return f"http://127.0.0.1:{srv.port}"


def _engine(tm, **kw):
    base = dict(max_new_tokens=4, num_slots=4, max_len=64,
                prefill_buckets=(32,), cache_dtype=torch.float32)
    return EngineChat(tm, _Tok(), **{**base, **kw})


def test_chat_http_server_openai_roundtrip(models):
    """POST /v1/chat/completions with text, a data-URL image and history
    over a socket (VlaserChat backend); /v1/models, /health; 400 without a
    user message."""
    cfg, _, _, tm = models
    chat = VlaserChat(tm, _Tok(), max_new_tokens=4, bucket=32,
                      cache_dtype=torch.float32)
    srv = ChatHTTPServer(chat, host="127.0.0.1", port=0,
                         model_name="tiny-vlaser", max_tiles=2)
    assert srv.image_size == cfg.vision.image_size
    url = _serving(srv)
    try:
        out = chat_completion_request(url, [
            {"role": "user", "content": "what do you see?"}])
        assert out["object"] == "chat.completion"
        text1 = out["choices"][0]["message"]["content"]
        assert isinstance(text1, str) and text1
        rng = np.random.default_rng(13)
        out2 = chat_completion_request(url, [{"role": "user", "content": [
            {"type": "text", "text": "describe the image"},
            {"type": "image_url", "image_url": {"url": _data_url(rng)}}]}])
        assert isinstance(out2["choices"][0]["message"]["content"], str)
        out3 = chat_completion_request(url, [
            {"role": "user", "content": "what do you see?"},
            {"role": "assistant", "content": text1},
            {"role": "user", "content": "and now?"}])
        assert isinstance(out3["choices"][0]["message"]["content"], str)
        with urllib.request.urlopen(url + "/v1/models", timeout=10) as r:
            assert json.loads(r.read())["data"][0]["id"] == "tiny-vlaser"
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"messages": [{"role": "assistant", "content": "x"}]})
        assert ei.value.code == 400
    finally:
        srv.shutdown()


def test_chat_http_server_batches_concurrent_requests(models):
    """EngineChat backend: three concurrent requests collect into fewer
    chat_many admissions than requests (250 ms window), each response equal
    to that request's solo chat()."""
    _, _, _, tm = models
    served = _engine(tm)
    qs = ["what is here?", "count the cups", "name one color"]
    want = [served.chat(q) for q in qs]
    assert served.chat_many([(q, None, None) for q in qs]) == want
    srv = ChatHTTPServer(served, host="127.0.0.1", port=0,
                         batch_wait_ms=250)
    assert srv._queue is not None
    url = _serving(srv)
    try:
        outs = [None] * len(qs)

        def fire(i):
            outs[i] = chat_completion_request(url, [
                {"role": "user", "content": qs[i]}])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert [o["choices"][0]["message"]["content"] for o in outs] == want
        assert srv.batches_served < len(qs)
    finally:
        srv.shutdown()


def test_chat_http_server_stream_shim(models):
    """VlaserChat backend: "stream": true answers one SSE delta + [DONE]
    holding the non-streaming content."""
    _, _, _, tm = models
    chat = VlaserChat(tm, _Tok(), max_new_tokens=4, bucket=32,
                      cache_dtype=torch.float32)
    srv = ChatHTTPServer(chat, host="127.0.0.1", port=0)
    url = _serving(srv)
    try:
        msgs = [{"role": "user", "content": "what is here?"}]
        want = chat_completion_request(url, msgs)[
            "choices"][0]["message"]["content"]
        lines = _post(url, {"stream": True, "messages": msgs}, timeout=60)
        assert lines[-1] == "data: [DONE]"
        delta = json.loads(lines[0][len("data: "):])
        assert delta["object"] == "chat.completion.chunk"
        assert delta["choices"][0]["delta"]["content"] == want
    finally:
        srv.shutdown()


def test_chat_http_server_true_streaming_with_engine(models):
    """EngineChat backend (chunk 2, 8 new tokens): several SSE deltas from
    the on_token hook that concatenate to the non-streaming text, then a
    stop chunk and [DONE]."""
    _, _, _, tm = models
    served = _engine(tm, max_new_tokens=8, num_slots=2, chunk_size=2)
    srv = ChatHTTPServer(served, host="127.0.0.1", port=0, batch_wait_ms=20)
    url = _serving(srv)
    try:
        msgs = [{"role": "user", "content": "what is here?"}]
        want = chat_completion_request(url, msgs)[
            "choices"][0]["message"]["content"]
        events = _post(url, {"stream": True, "messages": msgs})
        assert events[-1] == "data: [DONE]"
        parsed = [json.loads(e[len("data: "):]) for e in events[:-1]]
        deltas = [p["choices"][0]["delta"].get("content", "") for p in parsed]
        assert sum(1 for d in deltas if d) >= 2
        assert "".join(deltas).strip() == want
        assert parsed[-1]["choices"][0]["finish_reason"] == "stop"
    finally:
        srv.shutdown()


def test_chat_http_server_max_tokens_and_multimage(models):
    """History pairing (a leading assistant greeting, consecutive user
    turns), two images -> two tile counts and two <image> tags, a content-
    parts system message; per-request max_tokens honored by the engine,
    clamped to its max_new_tokens and reported in usage."""
    _, _, _, tm = models
    rng = np.random.default_rng(23)
    q, px, hist, system, npl = _parse_messages([
        {"role": "system", "content": [{"type": "text", "text": "be brief"}]},
        {"role": "assistant", "content": "hello! how can I help?"},
        {"role": "user", "content": "hi"},
        {"role": "user", "content": "actually, one question"},
        {"role": "assistant", "content": "go ahead"},
        {"role": "user", "content": [
            {"type": "text", "text": "compare these"},
            {"type": "image_url", "image_url": {"url": _data_url(rng, 40)}},
            {"type": "image_url", "image_url": {"url": _data_url(rng, 40)}}]},
    ], max_tiles=4, image_size=28)
    assert system == "be brief"
    assert hist == [("actually, one question", "go ahead")]
    assert npl is not None and len(npl) == 2 and px.shape[0] == sum(npl)
    assert q.count("<image>") == 2

    srv = ChatHTTPServer(_engine(tm, max_new_tokens=8, num_slots=2),
                         host="127.0.0.1", port=0, batch_wait_ms=5)
    url = _serving(srv)
    try:
        msgs = [{"role": "user", "content": "hi?"}]
        full = _post(url, {"messages": msgs})
        capped = _post(url, {"max_tokens": 2, "messages": msgs})
        n_full = len(full["choices"][0]["message"]["content"].split())
        n_capped = len(capped["choices"][0]["message"]["content"].split())
        assert n_capped <= 2 < n_full
        assert capped["usage"]["max_new_tokens"] == 2
        assert capped["usage"]["max_new_tokens_cap"] == 8
        over = _post(url, {"max_tokens": 4096, "messages": msgs})
        assert over["usage"]["max_new_tokens"] == 8
    finally:
        srv.shutdown()


def _messages(rng):
    """Message lists for the cross-package parse: text only, history with a
    system prompt, one image, two images (a system message as content
    parts), and a question that already holds one <image> tag."""
    u = lambda: {"type": "image_url", "image_url": {"url": _data_url(
        rng, int(rng.integers(30, 90)))}}
    return [
        [{"role": "user", "content": "what is here?"}],
        [{"role": "system", "content": "be brief"},
         {"role": "user", "content": "hi"},
         {"role": "assistant", "content": "hello"},
         {"role": "user", "content": "and now?"}],
        [{"role": "user", "content": [{"type": "text", "text": "describe"},
                                      u()]}],
        [{"role": "system", "content": [{"type": "text", "text": "robot"}]},
         {"role": "user", "content": [u(), {"type": "text", "text": "a"},
                                      u(), {"type": "text", "text": "b"}]}],
        [{"role": "user", "content": [
            {"type": "text", "text": "<image>\ncompare"}, u(), u()]}],
    ]


@pytest.mark.parametrize("max_tiles", [1, 4, 12])
def test_parse_messages_matches_jax(max_tiles):
    """The same messages, data-URL PNGs included, give bit-equal tiles and
    the same question, history, system prompt and num_patches_list in both
    packages."""
    for msgs in _messages(np.random.default_rng(max_tiles)):
        got = _parse_messages(msgs, max_tiles, 28)
        want = jserver._parse_messages(msgs, max_tiles, 28)
        assert got[0] == want[0] and got[2] == want[2]
        assert got[3] == want[3] and got[4] == want[4]
        if want[1] is None:
            assert got[1] is None
        else:
            assert got[1].dtype == want[1].dtype
            assert np.array_equal(got[1], want[1])


def _conversation(rng):
    return [
        [{"role": "user", "content": "what do you see?"}],
        [{"role": "user", "content": [
            {"type": "text", "text": "describe the image"},
            {"type": "image_url", "image_url": {"url": _data_url(rng)}}]}],
        [{"role": "user", "content": "hi"},
         {"role": "assistant", "content": "7 8 9"},
         {"role": "user", "content": "and now?"}],
    ]


@pytest.mark.parametrize("backend", ["static", "engine"])
def test_jax_and_port_servers_answer_alike(models, backend):
    """A JAX server and a port server over the same tiny weights (fp32)
    answer the same content to the same requests: text, a data-URL image,
    history; the engine backend with a max_tokens too."""
    cfg, jm, v, tm = models
    if backend == "static":
        kw = dict(max_new_tokens=4, bucket=32)
        jchat = JaxChat(jm, v, _Tok(), cache_dtype=jnp.float32, **kw)
        chat = VlaserChat(tm, _Tok(), cache_dtype=torch.float32, **kw)
    else:
        kw = dict(max_new_tokens=5, num_slots=2, max_len=96,
                  prefill_buckets=(32, 64))
        jchat = JaxEngineChat(jm, v, _Tok(), cache_dtype=jnp.float32, **kw)
        chat = EngineChat(tm, _Tok(), cache_dtype=torch.float32, **kw)
    jsrv = jserver.ChatHTTPServer(jchat, host="127.0.0.1", port=0,
                                  max_tiles=2, batch_wait_ms=5)
    srv = ChatHTTPServer(chat, host="127.0.0.1", port=0, max_tiles=2,
                         batch_wait_ms=5)
    jurl, url = _serving(jsrv), _serving(srv)
    try:
        payloads = [{"messages": m}
                    for m in _conversation(np.random.default_rng(5))]
        if backend == "engine":
            payloads.append({"max_tokens": 2, **payloads[0]})
        for p in payloads:
            want, got = _post(jurl, p), _post(url, p)
            assert got["choices"] == want["choices"]
            assert got["usage"] == want["usage"]
    finally:
        jsrv.shutdown()
        srv.shutdown()


class _StubChat:
    """A static backend answering `text`; it records the grad mode of the
    thread that serves it."""

    def __init__(self, text, fail=False):
        self.tokenizer = ByteTokenizer()
        self.text, self.fail, self.grad = text, fail, []
        self.max_new_tokens = 64

    def chat(self, question, pixels, history=None, num_patches_list=None):
        self.grad.append(torch.is_grad_enabled())
        if self.fail:
            raise RuntimeError("backend down")
        return self.text


class _StubStream(_StubChat):
    """A chat_many backend that streams the byte tokens of `text` one by
    one (multi-byte characters split across tokens)."""

    def chat_many(self, items, on_token=None):
        self.grad.append(torch.is_grad_enabled())
        if self.fail:
            raise RuntimeError("backend down")
        ids = self.tokenizer(self.text)["input_ids"]
        for i in range(len(items)):
            for t in ids:
                if on_token is not None:
                    on_token(i, t)
        return [self.text] * len(items)


def test_sse_holds_back_a_decode_that_ends_mid_utf8():
    """Multi-byte characters arrive split over byte tokens: no delta ever
    carries the transient replacement character, and the deltas
    concatenate to the final text."""
    text = "héllo € 中文 ok"
    backend = _StubStream(text)
    srv = ChatHTTPServer(backend, host="127.0.0.1", port=0, batch_wait_ms=1)
    url = _serving(srv)
    try:
        events = _post(url, {"stream": True, "messages": [
            {"role": "user", "content": "hi"}]})
        deltas = [json.loads(e[len("data: "):])["choices"][0]["delta"]
                  .get("content", "") for e in events[:-1]]
        assert events[-1] == "data: [DONE]"
        assert all("�" not in d for d in deltas)
        assert "".join(deltas) == text
        assert len([d for d in deltas if d]) > 5
    finally:
        srv.shutdown()


@pytest.mark.parametrize("queued", [False, True], ids=["static", "batched"])
def test_backend_failure_answers_500_and_no_thread_builds_a_graph(queued):
    """A backend exception answers 500 on both routes (the serialized
    static path and the batch worker); the backend is called with grad
    mode off in the server's threads."""
    backend = (_StubStream if queued else _StubChat)("ok", fail=True)
    srv = ChatHTTPServer(backend, host="127.0.0.1", port=0, batch_wait_ms=1)
    assert (srv._queue is not None) == queued
    url = _serving(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"messages": [{"role": "user", "content": "hi"}]})
        assert ei.value.code == 500
        backend.fail = False
        out = _post(url, {"messages": [{"role": "user", "content": "hi"}]})
        assert out["choices"][0]["message"]["content"] == "ok"
        assert backend.grad == [False, False]
    finally:
        srv.shutdown()


class _Echo(_StubChat):
    """chat_many answers each item with its own question, streaming its
    characters' byte tokens; records the batch sizes."""

    def __init__(self):
        super().__init__("")
        self.sizes = []

    def chat_many(self, items, on_token=None):
        self.sizes.append(len(items))
        for i, it in enumerate(items):
            for t in self.tokenizer(it[0])["input_ids"]:
                if on_token is not None:
                    on_token(i, t)
        return [it[0] for it in items]


def test_bursts_beyond_the_default_backlog_are_all_served():
    """Bursts of 32 concurrent clients (more than socketserver's default
    backlog of 5, which reset connections) under a short switch interval:
    every request is answered 200 with its own text, streamed or not, and
    the batches hold every request once."""
    import sys

    backend = _Echo()
    srv = ChatHTTPServer(backend, host="127.0.0.1", port=0, batch_wait_ms=2)
    assert srv._httpd.request_queue_size == chat_server.BACKLOG >= 32
    url = _serving(srv)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for burst in range(4):
            qs = [f"burst {burst} request {i} é" for i in range(32)]
            out = [None] * len(qs)
            go = threading.Barrier(len(qs))

            def fire(i):
                go.wait()
                p = {"messages": [{"role": "user", "content": qs[i]}],
                     "stream": i % 3 == 0}
                out[i] = _post(url, p, timeout=60)

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(len(qs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for i, o in enumerate(out):
                if i % 3 == 0:
                    text = "".join(json.loads(e[len("data: "):])["choices"][0]
                                   ["delta"].get("content", "")
                                   for e in o[:-1])
                else:
                    text = o["choices"][0]["message"]["content"]
                assert text == qs[i]
        assert sum(backend.sizes) == 4 * 32
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown()
