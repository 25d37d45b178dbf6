"""HTTP TTS server: demo page, GET /api/tts?text=...[&speaker_id=N] -> WAV
bytes, /health (≙ tts_tpu/server/server.py), over the port's
``Synthesizer``.

Run on the card:
    python -m tts_tpu_torch.server.server --tts_checkpoint glow.pt \\
        --tts_config configs/glow_tts_ljspeech.json \\
        [--vocoder_checkpoint mbmelgan.pt \\
         --vocoder_config configs/multiband_melgan.json]

Without a vocoder the server answers with Griffin-Lim audio, as tts_tpu's
does. A ``speaker_id`` that is not an integer, or not one of the model's
speakers, is answered with 400 before anything reaches the card. Checkpoints may be the port's or tts_tpu's (see ``Synthesizer``).
``--prewarm`` serves one sentence per text bucket before it listens
(``Synthesizer.prewarm``).
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tts_tpu_torch.audio.processor import wav_to_bytes
from tts_tpu_torch.infer.synthesis import check_speaker_id

_DEMO_PAGE = """<!DOCTYPE html>
<html>
<head><title>tts_tpu_torch demo</title></head>
<body style="font-family: sans-serif; max-width: 640px; margin: 40px auto;">
  <h1>tts_tpu_torch</h1>
  <p>Type a sentence and press Speak.</p>
  <input id="text" size="60" value="Hello, world!"/>
  <button onclick="speak()">Speak</button>
  <p id="status"></p>
  <audio id="audio" controls></audio>
  <script>
    function speak() {
      const t = document.getElementById('text').value;
      document.getElementById('status').textContent = 'synthesizing...';
      const audio = document.getElementById('audio');
      audio.src = '/api/tts?text=' + encodeURIComponent(t);
      audio.onloadeddata = () => {
        document.getElementById('status').textContent = '';
        audio.play();
      };
    }
  </script>
</body>
</html>"""


def make_handler(synthesizer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, body: bytes, content_type: str) -> None:
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(_DEMO_PAGE.encode(), "text/html")
            elif url.path == "/api/tts":
                qs = parse_qs(url.query)
                text = qs.get("text", [""])[0]
                if not text:
                    self.send_error(400, "missing text parameter")
                    return
                speaker = qs.get("speaker_id", [None])[0]
                try:
                    speaker_id = int(speaker) if speaker else None
                    check_speaker_id(synthesizer.model, speaker_id)
                except ValueError as e:
                    self.send_error(400, f"bad speaker_id: {e}")
                    return
                try:
                    wav = synthesizer.tts(text, speaker_id=speaker_id)
                except Exception as e:  # surface synthesis errors as 500s
                    self.send_error(500, str(e))
                    return
                self._send(wav_to_bytes(wav, synthesizer.ap.sample_rate),
                           "audio/wav")
            elif url.path == "/health":
                self._send(json.dumps({"status": "ok"}).encode(),
                           "application/json")
            else:
                self.send_error(404)

    return Handler


def create_server(synthesizer, port: int = 5002,
                  host: str = "0.0.0.0") -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(synthesizer))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tts_checkpoint", required=True)
    parser.add_argument("--tts_config", required=True)
    parser.add_argument("--vocoder_checkpoint", default=None)
    parser.add_argument("--vocoder_config", default=None)
    parser.add_argument("--port", type=int, default=5002)
    parser.add_argument("--device", default=None,
                        help="torch device; CUDA unless given (e.g. cpu)")
    parser.add_argument("--prewarm", action="store_true",
                        help="serve one sentence per text bucket before "
                             "listening, so the first request does not pay "
                             "the process's first-use costs")
    args = parser.parse_args(argv)
    if args.vocoder_checkpoint and not args.vocoder_config:
        parser.error("--vocoder_checkpoint needs --vocoder_config")

    from tts_tpu_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(args.tts_checkpoint, args.tts_config,
                        args.vocoder_checkpoint, args.vocoder_config,
                        device=args.device)
    if args.prewarm:
        synth.prewarm()
    server = create_server(synth, args.port)
    print(f" > Serving on http://localhost:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
