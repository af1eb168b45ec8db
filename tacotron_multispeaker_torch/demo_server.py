"""HTTP demo server (stdlib ``http.server``).

    python -m tacotron_multispeaker_torch.demo_server --checkpoint_dir runs/logs-tiny/checkpoints \
        --preset tiny [--port 9000] [--device cpu]

Port of the root ``demo_server.py``:

* ``GET /synthesize?text=...&speaker_id=N`` → ``audio/wav`` (400 without a
  text);
* ``GET /`` → a minimal HTML form;
* any other path → 404.

``Synthesizer.warmup()`` runs before the server listens.  ``--port 0``
binds a free port; the line ``serving on http://localhost:<port>`` names
it.  Requests run on threads (``ThreadingHTTPServer``) that share one
``Synthesizer``; a lock lets one synthesis run at a time, so requests never
interleave their launches on the device.  Runs on the CUDA device unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

HTML = b"""<!doctype html><title>tacotron demo</title>
<h3>tacotron-multispeaker</h3>
<form action=/synthesize>
<input name=text size=60 placeholder="Type something...">
<input name=speaker_id value=0 size=4>
<button>Speak</button></form>"""


class Handler(BaseHTTPRequestHandler):
    """The routes; :func:`make_server` binds a ``Synthesizer`` and a lock
    to a subclass of its own."""
    synthesizer = None
    lock = None

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/":
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(HTML)
            return
        if url.path == "/synthesize":
            q = parse_qs(url.query)
            text = (q.get("text") or [""])[0]
            sid = int((q.get("speaker_id") or ["0"])[0])
            if not text:
                self.send_error(400, "missing text")
                return
            with self.lock:
                wav = self.synthesizer.synthesize(text, sid)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            self.wfile.write(wav)
            return
        self.send_error(404)


def make_server(synthesizer, port: int, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """A server for ``synthesizer`` bound to ``port`` (0: a free one; read it
    from ``server.server_address[1]``); ``serve_forever()`` runs it."""
    handler = type("BoundHandler", (Handler,), {"synthesizer": synthesizer,
                                                "lock": threading.Lock()})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m tacotron_multispeaker_torch.demo_server")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--preset", default="single_speaker")
    p.add_argument("--hparams", default="")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    from .config import get_config
    from .synthesizer import Synthesizer
    cfg = get_config(args.preset, args.hparams)
    syn = Synthesizer(cfg, device=args.device).load(args.checkpoint_dir)
    print("warming up (all input buckets)...", flush=True)
    syn.warmup()
    server = make_server(syn, args.port)
    print(f"serving on http://localhost:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
