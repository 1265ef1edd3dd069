"""Serve the port's pipeline over HTTP.

A JSON `POST /analyze` with a wav or flac body, `/health`, `/stats` and a
demo page, with the cross-request `MicroBatcher` (`serve/batching.py`):
the port's copies of the reference package's stdlib server
(`serve/http_server.make_handler`/`serve`) in front of the port's
pipeline. Run:

    python -m audio_transformers_tpu_torch.serve.http_server \
        [--model_path DIR] [--tokenizer NAME] [--device cuda|cpu] \
        [--port 8501]

`--model_path` takes a checkpoint directory the trainer wrote or an HF
directory (`cli.common.load_pipeline`); without it the weights are seeded
random whisper-tiny. `--tokenizer` names an HF tokenizer (default: the
byte tokenizer). `--params` (a `.pt` of a port parameter tree, e.g.
`core.params.from_jax_params` of a JAX tree) with `--config` (a whisper
size) serves a bare tree instead. The server runs on the card;
`--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from audio_transformers_tpu_torch.cli import common
from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                               WhisperConfig)
from audio_transformers_tpu_torch.core.params import init, resolve_device
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.serve.batching import MicroBatcher
from audio_transformers_tpu_torch.utils.audio import (decode_audio_bytes,
                                                      to_mono)

__all__ = ["MicroBatcher", "build_pipeline", "main", "make_handler", "serve"]


def build_pipeline(*, model_path=None, tokenizer=None, config: str = "tiny",
                   params_path=None, kv_quant: str = "none",
                   num_beams: int = 1,
                   device="cuda") -> EmotionWhisperPipeline:
    """The served pipeline on `device` (bfloat16 on the card, float32 on
    the CPU; raises when CUDA is asked for and absent). `model_path` (a
    checkpoint or HF directory) or, with neither it nor `params_path`,
    seeded whisper-tiny goes through `cli.common.load_pipeline`. Otherwise
    the weights are the saved tree at `params_path` (its emotion head
    gives the class count) or a seeded init of the `config` size with 10
    classes. num_beams > 1 serves beam-search decoding."""
    kw = dict(tokenizer=tokenizer, kv_quant=kv_quant, num_beams=num_beams,
              device=device)
    if params_path is None and config == "tiny":
        return common.load_pipeline(model_path, **kw)
    if model_path is not None:
        raise ValueError("a model path holds its own weights and config: "
                         "pass it without params_path or config")
    device = resolve_device(device)
    if params_path:
        params = torch.load(params_path, map_location="cpu")
        n_classes = params["emotion_head"]["w"].shape[0]
    else:
        params, n_classes = None, 10
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.by_name(config),
                               num_emotion_classes=n_classes)
    if params is None:
        params = init(cfg, torch.Generator().manual_seed(0))
    return EmotionWhisperPipeline(params, cfg, **kw)


_PAGE = """<!doctype html>
<html><head><title>audio-transformers-tpu demo</title><style>
body{font-family:sans-serif;max-width:760px;margin:2em auto;padding:0 1em}
.bar{height:14px;background:#4a7dbd;display:inline-block;vertical-align:middle}
.seg{margin:1em 0;padding:.6em;border:1px solid #ddd;border-radius:6px}
.lab{display:inline-block;width:120px;font-size:13px}
blockquote{background:#f6f6f6;padding:.8em;border-left:4px solid #4a7dbd}
</style></head><body>
<h2>Audio Emotion Recognition + Transcription</h2>
<p>Upload a wav or flac file; the model transcribes it and estimates an
emotion per %SEG%-second segment.</p>
<input type="file" id="f" accept=".wav,.flac"/> <button onclick="go()">Analyze</button>
<div id="out"></div>
<script>
function fail(msg){
  document.getElementById('out').innerHTML=
    '<p style="color:#b00">'+msg+'</p>';
}
async function go(){
  const f=document.getElementById('f').files[0];
  if(!f){alert('choose a wav or flac file');return}
  document.getElementById('out').innerHTML='<p>processing...</p>';
  let r,d=null;
  try{
    r=await fetch('/analyze',{method:'POST',body:await f.arrayBuffer()});
    try{d=await r.json();}catch(e){}
  }catch(e){
    // e.g. the server 413s and closes mid-upload: fetch rejects and,
    // unhandled, would leave the page stuck on 'processing...'
    fail('request failed: '+e);
    return;
  }
  if(!r.ok||d===null){
    fail('error ('+r.status+'): '+((d&&d.error)||'request failed'));
    return;
  }
  let h='<h3>Transcription</h3><blockquote>'+(d.transcription||'(empty)')+
        '</blockquote><h3>Segments</h3>';
  for(const s of d.segments){
    h+='<div class="seg"><b>'+s.start.toFixed(1)+'s - '+s.end.toFixed(1)+
       's</b> &mdash; '+s.emotion+'<br/>';
    const entries=Object.entries(s.emotion_probs).sort((a,b)=>b[1]-a[1]);
    for(const [k,v] of entries){
      h+='<span class="lab">'+k+'</span><span class="bar" style="width:'+
         (v*300)+'px"></span> '+(v*100).toFixed(1)+'%<br/>';
    }
    h+='</div>';
  }
  document.getElementById('out').innerHTML=h;
}
</script></body></html>"""


def _parse_audio(data: bytes):
    """wav (stdlib) or flac (native decoder) -> (mono float32, sr).
    Raises ValueError for other containers (mapped to HTTP 415)."""
    audio, sr = decode_audio_bytes(data)
    return to_mono(audio), sr


def make_handler(pipeline, segment_duration: float, batcher=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                page = _PAGE.replace("%SEG%", str(segment_duration))
                self._send(200, page.encode(), "text/html")
            elif self.path == "/health":
                self._send(200, b'{"status":"ok"}', "application/json")
            elif self.path == "/stats":
                stats = {"microbatch": batcher is not None}
                if batcher is not None:
                    stats.update(batcher.stats)
                self._send(200, json.dumps(stats).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        # 30 s * 16 kHz * 4 B float32 wav is ~1.9 MB; 256 MB covers any
        # plausible long-form upload while bounding a hostile
        # Content-Length (one unchecked read could exhaust host memory)
        MAX_BODY = 256 * 1024 * 1024

        def do_POST(self):
            if self.path != "/analyze":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", ""))
            except ValueError:
                n = -1
            if n < 0:  # absent, malformed, or negative: read(-1) would
                # buffer an attacker's stream until EOF — refuse instead
                self._send(411, json.dumps(
                    {"error": "missing or malformed Content-Length"}
                ).encode(), "application/json")
                return
            if n > self.MAX_BODY:
                self._send(413, json.dumps(
                    {"error": f"body too large ({n} bytes; "
                              f"max {self.MAX_BODY})"}).encode(),
                    "application/json")
                return
            data = self.rfile.read(n)
            try:
                audio, sr = _parse_audio(data)
            except ValueError as e:
                # unsupported container -> 415, like the spec intends
                code = 415 if "unsupported audio container" in str(e) else 400
                self._send(code, json.dumps(
                    {"error": str(e)}).encode(), "application/json")
                return
            except Exception as e:
                self._send(400, json.dumps(
                    {"error": f"bad audio: {e}"}).encode(),
                    "application/json")
                return
            try:
                result = pipeline.analyze(
                    audio, sr, segment_duration=segment_duration,
                    runner=batcher.runner if batcher is not None else None)
            except Exception as e:  # device/batcher error -> JSON 500,
                # not a dropped socket (the client would hang on
                # 'processing...' forever)
                self._send(500, json.dumps(
                    {"error": f"inference failed: {e}"}).encode(),
                    "application/json")
                return
            self._send(200, json.dumps(result).encode(), "application/json")

    return Handler


def serve(pipeline, *, host: str = "127.0.0.1", port: int = 8501,
          segment_duration: float = 5.0, microbatch: bool = True,
          max_wait_ms: float = 10.0):
    """microbatch: decode concurrent requests as one padded device batch
    (serve/batching.MicroBatcher) — a lone request pays at most
    `max_wait_ms` extra; concurrent requests save a full decode each."""
    batcher = None
    if microbatch:
        batcher = MicroBatcher(pipeline.analyze_windows,
                               max_wait_ms=max_wait_ms)
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(pipeline, segment_duration, batcher))
    print(f"[serve] listening on http://{host}:{port} "
          f"(microbatch={'on' if batcher else 'off'})")
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve the emotion demo (PyTorch)")
    p.add_argument("--model_path", default=None,
                   help="checkpoint dir or HF dir; default: seeded init")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer path (default: byte tokenizer)")
    p.add_argument("--params", default=None,
                   help=".pt of a port parameter tree (instead of "
                        "--model_path)")
    p.add_argument("--config", default="tiny",
                   help="whisper size of --params or of a seeded init "
                        "(tiny, base, ..., test)")
    p.add_argument("--kv_quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="quantize the decode K/V caches (the cross K/V in "
                        "int8 or nibble-packed int4, the self K/V in int8)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cpu)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--segment_duration", type=float, default=5.0)
    p.add_argument("--no_microbatch", action="store_true")
    p.add_argument("--microbatch_wait_ms", type=float, default=10.0)
    args = p.parse_args(argv)
    pipeline = build_pipeline(model_path=args.model_path,
                              tokenizer=common.get_tokenizer(args.tokenizer),
                              config=args.config, params_path=args.params,
                              kv_quant=args.kv_quant, device=args.device)
    serve(pipeline, host=args.host, port=args.port,
          segment_duration=args.segment_duration,
          microbatch=not args.no_microbatch,
          max_wait_ms=args.microbatch_wait_ms)


if __name__ == "__main__":
    main()
