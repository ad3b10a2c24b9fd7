"""HTTP policy serving (the RoboTwin deploy server, stdlib-only).

Parity surface: RoboTwin policy vla-scripts/deploy.py — a FastAPI/uvicorn
`POST /act` endpoint taking {"image": ndarray, "instruction": str} (+ qpos)
and returning the action chunk. Rebuilt on http.server (no fastapi in the
image) with a json-numpy-style array encoding: arrays travel as
{"__ndarray__": base64, "dtype": ..., "shape": ...}; plain nested lists are
accepted too.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np


def encode_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {
        "__ndarray__": base64.b64encode(a.tobytes()).decode("ascii"),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__ndarray__" in v:
        buf = base64.b64decode(v["__ndarray__"])
        return np.frombuffer(buf, dtype=np.dtype(v["dtype"])).reshape(v["shape"])
    if isinstance(v, list):
        return np.asarray(v)
    return v


class PolicyHTTPServer:
    """Serves `policy_fn(image, instruction, qpos) -> np.ndarray actions`.

    POST /act       -> {"action": <encoded ndarray>}
    POST /reset     -> {"ok": true} (calls policy.reset(instruction) if given)
    GET  /health    -> {"ok": true}
    """

    def __init__(self, policy_fn: Callable, host: str = "0.0.0.0",
                 port: int = 8000, reset_fn: Optional[Callable] = None):
        self.policy_fn = policy_fn
        self.reset_fn = reset_fn
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

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    self._send(400, {"error": f"bad json: {e}"})
                    return
                if self.path == "/reset":
                    if outer.reset_fn is not None:
                        outer.reset_fn(req.get("instruction", ""))
                    self._send(200, {"ok": True})
                    return
                if self.path != "/act":
                    self._send(404, {"error": "unknown path"})
                    return
                try:
                    image = decode_value(req["image"])
                    instruction = req.get("instruction", "")
                    qpos = req.get("qpos")
                    qpos = decode_value(qpos) if qpos is not None else None
                    action = np.asarray(
                        outer.policy_fn(image, instruction, qpos)
                    )
                    self._send(200, {"action": encode_array(action)})
                except KeyError as e:
                    self._send(400, {"error": f"missing field {e}"})
                except Exception as e:  # mirror deploy.py's traceback reply
                    import traceback

                    self._send(500, {"error": str(e),
                                     "traceback": traceback.format_exc()})

        self._httpd = ThreadingHTTPServer((host, port), Handler)

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


def act_request(url: str, image: np.ndarray, instruction: str,
                qpos: Optional[np.ndarray] = None, timeout: float = 30.0):
    """Stdlib client (deploy.py documents a requests-based client)."""
    import urllib.request

    payload: Dict[str, Any] = {
        "image": encode_array(np.asarray(image)),
        "instruction": instruction,
    }
    if qpos is not None:
        payload["qpos"] = encode_array(np.asarray(qpos))
    req = urllib.request.Request(
        url.rstrip("/") + "/act", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    return decode_value(out["action"])
