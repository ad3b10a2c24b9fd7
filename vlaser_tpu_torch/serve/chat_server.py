"""OpenAI-compatible HTTP chat serving, stdlib only (port of
vlaser_tpu/serve/chat_server.py, the vLLM API-server role of the
reference's QA pipeline: data-pipeline/RoboTwin-QA/GeneralQA.py:3-8).

`POST /v1/chat/completions` over a chat backend with VlaserChat's surface:
`inference/chat.VlaserChat` (static, serialized on a lock; `"stream":
true` answers with one delta) or `serve/engine_chat.EngineChat`
(concurrent requests batch into one `chat_many` engine admission per
burst, and `"stream": true` sends real SSE deltas from the engine's
per-commit `on_token` hook, holding back a decode that ends mid-UTF-8).

Request schema (OpenAI chat-completions subset):
  {"model": "...", "messages": [{"role": "user"|"assistant"|"system",
   "content": "text" | [{"type": "text", "text": ...},
                        {"type": "image_url",
                         "image_url": {"url": "data:image/png;base64,..."
                                              | "file:///path"}}]}],
   "max_tokens": n, "stream": bool}
Earlier user/assistant turns become chat history; data-URL / file images
take the dynamic-tiling preprocess (image/tiling.load_image_tiles, PIL);
several images in one message keep one tile count each
(num_patches_list). A per-request `max_tokens` is clamped to the
backend's `max_new_tokens` and honored per request by EngineChat; the
response reports it in `usage`. A backend exception answers 500.

Grad mode is per thread in torch: every backend call the handler and
batch-worker threads make runs under `torch.no_grad()`, so that no
request builds an autograd graph.

One repair of the reference: its listen backlog is socketserver's default
of 5, and a burst of 16 concurrent clients had connections reset; here the
backlog is BACKLOG.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch


BACKLOG = 128  # pending connections the listening socket holds


class _Server(ThreadingHTTPServer):
    request_queue_size = BACKLOG


def _decode_image(url: str):
    """data:/file: image URL -> PIL image."""
    from PIL import Image

    if url.startswith("data:"):
        b64 = url.split(",", 1)[1]
        return Image.open(io.BytesIO(base64.b64decode(b64)))
    if url.startswith("file://"):
        return Image.open(url[len("file://"):])
    raise ValueError(
        f"unsupported image url scheme {url.split(':', 1)[0]!r} "
        "(data: and file:// are served; http fetch is not — no egress)"
    )


def _parse_messages(messages: List[Dict[str, Any]], max_tiles: int,
                    image_size: int = 448):
    """OpenAI messages -> (question, pixel_values|None, history, system).

    The LAST user message is the question; earlier user/assistant pairs
    become VlaserChat-style history; an initial system message passes
    through as the system prompt. Images are taken from the last user
    message's content parts (tiles concatenate in order)."""
    from ..image.tiling import load_image_tiles

    def text_and_images(content):
        if isinstance(content, str):
            return content, []
        texts, images = [], []
        for part in content:
            if part.get("type") == "text":
                texts.append(part.get("text", ""))
            elif part.get("type") == "image_url":
                images.append(_decode_image(part["image_url"]["url"]))
        return "\n".join(texts), images

    system = None
    turns: List[Dict[str, Any]] = []
    for m in messages:
        role = m.get("role")
        if role == "system":
            # OpenAI allows content-parts arrays for system messages too
            system, _ = text_and_images(m.get("content") or "")
            continue
        if role in ("user", "assistant"):
            turns.append(m)
    if not turns or turns[-1]["role"] != "user":
        raise ValueError("the last non-system message must be role=user")

    question, images = text_and_images(turns[-1]["content"])
    # history pairing tolerant of any legal sequence (leading assistant
    # greeting, consecutive user messages): each assistant turn closes
    # the most recent open user turn
    history = []
    pending_user = None
    for m in turns[:-1]:
        text, _ = text_and_images(m["content"])
        if m["role"] == "user":
            pending_user = text
        elif pending_user is not None:
            history.append((pending_user, text))
            pending_user = None
    pixel_values, num_patches_list = None, None
    if images:
        per_img = max(1, max_tiles // len(images))
        tiles = [load_image_tiles(im, image_size=image_size,
                                  max_num=per_img) for im in images]
        pixel_values = np.concatenate(tiles, axis=0)
        num_patches_list = [t.shape[0] for t in tiles]
        # each image needs its own <image> tag for the template render
        missing = len(images) - question.count("<image>")
        if missing > 0:
            question = "<image>\n" * missing + question
    return question, pixel_values, history or None, system, num_patches_list


class ChatHTTPServer:
    """POST /v1/chat/completions over a VlaserChat-surface backend.

    GET /health -> {"ok": true}; GET /v1/models lists the served name.
    """

    def __init__(self, chat, host: str = "0.0.0.0", port: int = 8000,
                 model_name: str = "vlaser-tpu", max_tiles: int = 12,
                 batch_wait_ms: float = 8.0):
        self.chat = chat
        self.model_name = model_name
        self.max_tiles = int(max_tiles)
        # tile size follows the served model's vision config
        self.image_size = int(getattr(
            getattr(getattr(chat, "cfg", None), "vision", None),
            "image_size", 448,
        ))
        self._lock = threading.Lock()
        # Cross-request batching (the vLLM API-server behavior): when the
        # backend exposes chat_many (EngineChat), concurrent HTTP requests
        # collect into ONE continuous-batching admission — a worker drains
        # the queue after a short batch window instead of each handler
        # thread serializing on the lock. VlaserChat backends (no
        # chat_many) keep the serialized path.
        self.batch_wait_s = float(batch_wait_ms) / 1e3
        self.batches_served = 0
        self._queue: Optional[list] = None
        self._queue_cv: Optional[threading.Condition] = None
        if hasattr(chat, "chat_many"):
            self._queue = []
            self._queue_cv = threading.Condition()
            self._worker = threading.Thread(target=self._batch_worker,
                                            daemon=True)
            self._worker.start()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse_event(self, payload: Dict):
                self.wfile.write(
                    f"data: {json.dumps(payload)}\n\n".encode())
                self.wfile.flush()

            def _stream_sse(self, rid, question, pixels, history,
                            npl, max_new):
                sq = outer._enqueue_stream(question, pixels, history,
                                           npl, max_new)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                # from here on the 200 + SSE headers are on the wire: any
                # failure must terminate the stream in-band, never via
                # _send(500) (which would inject a status line mid-body)

                def delta_event(delta, finish=None):
                    self._sse_event({
                        "id": rid,
                        "object": "chat.completion.chunk",
                        "model": outer.model_name,
                        "choices": [{
                            "index": 0,
                            "delta": ({"role": "assistant",
                                       "content": delta}
                                      if delta is not None else {}),
                            "finish_reason": finish,
                        }],
                    })

                toks: list = []
                prev = ""
                try:
                    while True:
                        kind, val = sq.get()
                        if kind == "tok":
                            toks.append(int(val))
                            cur = outer._stream_decode(toks)
                            # hold back while the decode ends mid-UTF-8
                            # (byte-level BPE splits multi-byte chars
                            # across tokens; emitting the transient
                            # replacement char would break the monotonic
                            # prefix and lock the stream out)
                            if cur.endswith("\ufffd"):
                                continue
                            # deltas only when the decode grows
                            # monotonically
                            if cur.startswith(prev) and \
                                    len(cur) > len(prev):
                                delta_event(cur[len(prev):])
                                prev = cur
                        elif kind == "done":
                            final = val
                            if final.startswith(prev) and \
                                    len(final) > len(prev):
                                delta_event(final[len(prev):])
                            delta_event(None, finish="stop")
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            return
                        else:  # err
                            self._sse_event({"error": str(val)})
                            return
                except Exception:
                    # client went away or decode failed mid-stream:
                    # best-effort in-band termination, never a second
                    # HTTP response
                    try:
                        self.wfile.write(b"data: [DONE]\n\n")
                    except Exception:
                        pass
                    return

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"ok": True})
                elif self.path == "/v1/models":
                    self._send(200, {"object": "list", "data": [
                        {"id": outer.model_name, "object": "model"}]})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/v1/chat/completions":
                    self._send(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    (question, pixels, history, system,
                     npl) = _parse_messages(
                        req["messages"], outer.max_tiles, outer.image_size
                    )
                    served_cap = getattr(outer.chat, "max_new_tokens",
                                         None)
                    max_new = None
                    if req.get("max_tokens") is not None:
                        max_new = max(1, int(req["max_tokens"]))
                        if served_cap is not None:
                            max_new = min(max_new, served_cap)
                except (KeyError, ValueError, IndexError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                except Exception as e:
                    self._send(400, {"error": f"bad json: {e}"})
                    return
                try:
                    if system is not None:
                        # per-request system messages would retrace the
                        # prompt; the constructor-level system_message
                        # is the supported path — surface the mismatch
                        cur = getattr(outer.chat, "system_message", None)
                        if cur not in (None, system):
                            raise ValueError(
                                "per-request system message differs "
                                "from the server's configured one"
                            )
                    rid = f"chatcmpl-{int(time.time() * 1e3)}"
                    if req.get("stream") and outer._queue is not None:
                        # REAL streaming through the engine: tokens arrive
                        # via the on_token commit hook (per decode chunk)
                        # and stream as SSE deltas; the response is
                        # close-delimited (no Content-Length)
                        self._stream_sse(rid, question, pixels, history,
                                         npl, max_new)
                        return
                    text = outer._serve_one(question, pixels, history,
                                            npl, max_new)
                    if req.get("stream"):
                        # VlaserChat backend has no commit hook: API-compat
                        # shim — one delta + [DONE], streaming CLIENTS work
                        chunk = json.dumps({
                            "id": rid,
                            "object": "chat.completion.chunk",
                            "model": outer.model_name,
                            "choices": [{
                                "index": 0,
                                "delta": {"role": "assistant",
                                          "content": text},
                                "finish_reason": "stop",
                            }],
                        })
                        body = (f"data: {chunk}\n\n"
                                "data: [DONE]\n\n").encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/event-stream")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    self._send(200, {
                        "id": rid,
                        "object": "chat.completion",
                        "model": outer.model_name,
                        "choices": [{
                            "index": 0,
                            "message": {"role": "assistant",
                                        "content": text},
                            "finish_reason": "stop",
                        }],
                        "usage": {
                            "completion_text_chars": len(text),
                            # served decode budget: the request's
                            # max_tokens clamped to the compiled length
                            # (engine backends honor it per request;
                            # VlaserChat serves the compiled length)
                            "max_new_tokens": (max_new if max_new
                                               is not None else served_cap),
                            "max_new_tokens_cap": served_cap,
                        },
                    })
                except Exception as e:
                    import traceback

                    self._send(500, {"error": str(e),
                                     "traceback": traceback.format_exc()})

        self._httpd = _Server((host, port), Handler)

    def _serve_one(self, question, pixels, history, npl=None,
                   max_new=None) -> str:
        if self._queue is None:  # VlaserChat backend: serialized path
            # VlaserChat's generate length is compiled; max_new is
            # reported in usage rather than honored per request
            with self._lock, torch.no_grad():
                return self.chat.chat(question, pixels, history=history,
                                      num_patches_list=npl)
        done = threading.Event()
        slot: Dict[str, Any] = {}
        with self._queue_cv:
            self._queue.append(
                ((question, pixels, history, npl, max_new), done, slot))
            self._queue_cv.notify()
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["text"]

    def _stream_decode(self, token_ids) -> str:
        """Incremental detokenization for SSE deltas: full-prefix decode
        (robust to merge boundaries; Completion token ids never contain
        EOS, so no separator stripping is needed)."""
        return self.chat.tokenizer.decode(token_ids,
                                          skip_special_tokens=True)

    def _enqueue_stream(self, question, pixels, history, npl=None,
                        max_new=None):
        """Register a STREAMING request with the batch worker: returns a
        per-request event queue fed ("tok", id) per committed token (the
        engine's on_token hook) and terminated by ("done", final_text) or
        ("err", exception)."""
        import queue as _queue_mod

        sq: Any = _queue_mod.Queue()
        slot: Dict[str, Any] = {"stream": sq}
        with self._queue_cv:
            self._queue.append(
                ((question, pixels, history, npl, max_new), None, slot))
            self._queue_cv.notify()
        return sq

    def _batch_worker(self):
        """Drain the request queue into chat_many batches: wake on the
        first request, hold the batch window open, take everything that
        arrived. One engine admission per HTTP burst; streaming requests
        in the batch get their tokens routed live through chat_many's
        on_token callback."""
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
            time.sleep(self.batch_wait_s)  # let the burst arrive
            with self._queue_cv:
                batch, self._queue[:] = self._queue[:], []
            items = [it for it, _, _ in batch]
            streams = {i: s["stream"] for i, (_, _, s)
                       in enumerate(batch) if "stream" in s}

            def route(i, tok):
                sq = streams.get(i)
                if sq is not None:
                    sq.put(("tok", tok))

            try:
                with self._lock, torch.no_grad():
                    texts = self.chat.chat_many(
                        items, on_token=route if streams else None)
                for (_, done, slot), text in zip(batch, texts):
                    if "stream" in slot:
                        slot["stream"].put(("done", text))
                    else:
                        slot["text"] = text
                        done.set()
            except Exception as e:  # noqa: BLE001 — delivered per request
                for _, done, slot in batch:
                    if "stream" in slot:
                        slot["stream"].put(("err", e))
                    else:
                        slot["error"] = e
                        done.set()
            self.batches_served += 1

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_forever(self):
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def chat_completion_request(url: str, messages: List[Dict[str, Any]],
                            model: str = "vlaser-tpu",
                            timeout: float = 120.0) -> Dict[str, Any]:
    """Stdlib client for the endpoint (an OpenAI SDK pointed at base_url
    works the same way)."""
    import urllib.request

    req = urllib.request.Request(
        url.rstrip("/") + "/v1/chat/completions",
        json.dumps({"model": model, "messages": messages}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())
