"""Minimal HTTP front end over the continuous-batching servers: the port's
copy of onnx_rusty_inference_engine_tpu/http_serve.py, with the same
requests, responses and error codes, so a client of the JAX server works
unchanged.

`serve_http(engine, port)` over serve.InferenceServer:

  POST /v1/infer     body: {"input": [[...]], "name": "data_0"?}
                     -> {"outputs": {name: [...]}, "top1": [...]}
  GET  /v1/stats     -> ServerStats summary
  GET  /metrics      -> the same numbers as Prometheus text
  GET  /healthz      -> ok

`serve_generate_http(decode_server, port)` over serving.DecodeServer:
POST /v1/generate (below). Requests from concurrent clients share the
server's device batches. A request that fails answers 400 with
{"error": ...} and the server stays up.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .serve import InferenceServer

__all__ = ["serve_http", "serve_generate_http"]


def _prometheus(stats: dict, prefix: str = "oriet") -> bytes:
    """stats dict -> Prometheus text exposition (gauges; counters keep
    their monotonic names). Scrapers get the same numbers /v1/stats
    serves as JSON."""
    lines = []
    for k, v in stats.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            name = f"{prefix}_{k}".replace(".", "_")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(v):g}")
    return ("\n".join(lines) + "\n").encode()


def _send_metrics(handler, stats: dict) -> None:
    body = _prometheus(stats)
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _make_handler(server: InferenceServer, input_name: str):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._send(200, server.stats.summary())
            elif self.path == "/metrics":
                _send_metrics(self, server.stats.summary())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/infer":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                x = np.asarray(req["input"], dtype=np.float32)
                out = server.infer(x, timeout=float(req.get("timeout", 300)))
                resp = {
                    "outputs": {k: v.tolist() for k, v in out.items()},
                    "top1": [int(np.argmax(v.reshape(v.shape[0], -1), axis=-1)[0])
                             for v in out.values()][:1],
                }
                self._send(200, resp)
            except Exception as e:  # request-level failure isolation
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_http(engine, port: int = 8000, input_name: Optional[str] = None,
               batch_buckets=(1, 2, 4, 8, 16), max_delay_s: float = 0.003,
               block: bool = True):
    """Start the HTTP server; returns (httpd, batching_server)."""
    batcher = InferenceServer(engine, input_name=input_name,
                              batch_buckets=batch_buckets,
                              max_delay_s=max_delay_s)
    name = input_name or engine.graph.input_names[0]
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(batcher, name))
    if block:
        try:
            httpd.serve_forever()
        finally:
            batcher.stop()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd, batcher


def _make_generate_handler(server):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so streamed responses can use chunked transfer coding
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._send(200, server.stats())
            elif self.path == "/metrics":
                _send_metrics(self, server.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                # a server may declare its source dtype through a family
                # spec (the JAX package's seq2seq servers do); token
                # decoders take int64 prompt ids
                dtype = getattr(getattr(server, "fam", None),
                                "prompt_dtype", np.int64)
                prompt = np.asarray(req.get("prompt_ids", req.get("src")),
                                    dtype=dtype)
                n_new = int(req.get("max_new_tokens", 16))
                eos = req.get("eos_id")
                kw = {}
                if req.get("stop_sequences") is not None:
                    kw["stop_sequences"] = req["stop_sequences"]
                # per-request sampling + LoRA adapter (DecodeServer)
                for k, cast in (("temperature", float), ("top_k", int),
                                ("top_p", float), ("min_p", float),
                                ("seed", int), ("adapter", int),
                                ("frequency_penalty", float),
                                ("presence_penalty", float)):
                    if req.get(k) is not None:
                        kw[k] = cast(req[k])
                if req.get("logit_bias") is not None:
                    kw["logit_bias"] = {int(t): float(b) for t, b
                                        in req["logit_bias"].items()}
                timeout = float(req.get("timeout", 300))
                eos_kw = None if eos is None else int(eos)
                if req.get("stream"):
                    return self._stream(prompt, n_new, eos_kw, timeout, kw)
                toks = server.generate(prompt, n_new, timeout=timeout,
                                       eos_id=eos_kw, **kw)
                self._send(200, {"prompt_ids": prompt.tolist(),
                                 "generated_ids": toks,
                                 "usage": {
                                     "prompt_tokens": int(prompt.size),
                                     "completion_tokens": len(toks),
                                     "total_tokens": int(prompt.size)
                                     + len(toks)}})
            except Exception as e:  # request-level failure isolation
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, prompt, n_new, eos_id, timeout, kw) -> None:
            """{"stream": true}: chunked NDJSON, one {"token": t} line per
            generated token as the slot produces it, then a closing
            {"done": true, "generated_ids": [...]} line. Tokens surface
            mid-generation — the slot keeps decoding in the shared batch
            while this handler thread drains the queue.

            Once the 200 + chunked headers are on the wire, failures may
            NOT start a second response (that would corrupt HTTP/1.1
            framing): they become a final {"error": ...} line and the
            stream terminates cleanly; a per-token timeout also cancels
            the server-side request so the slot is reclaimed."""
            import queue as _queue

            tq: "_queue.Queue" = _queue.Queue()
            fut = server.submit(prompt, n_new, eos_id=eos_id,
                                on_token=tq.put, **kw)
            # dispatcher emits all tokens before resolving, so the
            # sentinel is ordered after the last token
            fut.add_done_callback(lambda f: tq.put(None))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payload: dict) -> None:
                b = json.dumps(payload).encode() + b"\n"
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")

            try:
                while True:
                    try:
                        tok = tq.get(timeout=timeout)
                    except _queue.Empty:
                        server.cancel(fut)
                        chunk({"error": "timeout waiting for next token"})
                        break
                    if tok is None:
                        err = fut.exception(timeout=0)
                        if err is not None:
                            chunk({"error":
                                   f"{type(err).__name__}: {err}"})
                        else:
                            chunk({"done": True,
                                   "generated_ids": fut.result(0)})
                        break
                    chunk({"token": int(tok)})
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                # client hung up mid-stream: cancel the server-side
                # request so the slot is reclaimed at the next step
                # boundary (otherwise it decodes to max_new_tokens into
                # an orphaned queue), then close quietly — a second
                # response must never start on this connection
                server.cancel(fut)
                self.close_connection = True

    return Handler


def serve_generate_http(decode_server, port: int = 8001, block: bool = True):
    """HTTP front end over a continuous-batching generation server
    (serving.DecodeServer):

      POST /v1/generate  {"prompt_ids": [...] | "src": [...],
                          "max_new_tokens": N, "eos_id": t?,
                          "stop_sequences": [[...], ...]?}
                         -> {"generated_ids": [...]}
      GET  /v1/stats     -> server.stats()
      GET  /healthz      -> ok

    Concurrent requests share the slot pool (token-level batching)."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                _make_generate_handler(decode_server))
    if block:
        try:
            httpd.serve_forever()
        finally:
            decode_server.stop()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd
