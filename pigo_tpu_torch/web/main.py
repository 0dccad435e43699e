"""Web demos on the port: the in-browser webcam page, /detect and the MJPEG
stream, served by the card.

The counterpart of the JAX package's examples/web/main.py, with the same
routes:

  * `/`       — browser webcam page: getUserMedia -> canvas -> POST frames to
                /detect (3 in flight) -> draw the results in the page; keys
                e = eyes, f = landmarks, c = boxes; an FPS meter.
  * `/detect` — POST image bytes (JPEG or PNG) -> JSON detection results
                (the reference schema, cmd/pigo/main.go:89-100).
  * `/stats`  — the server's per-stage counters and its rolling FPS.
  * `/cam`    — annotated MJPEG stream from a server-side source (`--source`;
                needs OpenCV, imported only there).
  * `/?engine=client`, `/static/...`, `/cascade/...`, `/selftest`,
    `/golden/sample.json`, `/testdata/sample.gray` — the pure-JS client
                engine, the cascades it fetches and its in-browser self-test;
                the page, script and fixture are read from the checkout
                (examples/web/static/, tests/golden/sample.json).

The default engine is `cuda-stream` (engines.CudaStreamEngine: concurrent
requests are in flight together on the card); the JAX server defaults to
its native engine. `--device cpu` runs the cuda engines' plain PyTorch
versions on the host; with no card and no `--device cpu` the server does
not start. Images decode through Pillow (io/image.decode_image), where the
JAX server uses OpenCV: a JPEG can decode a level apart here and there
between the two, a PNG decodes the same.

    python -m pigo_tpu_torch.web.main --port 5000
    python -m pigo_tpu_torch.web.bench_client --concurrency 3
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pigo_tpu_torch.cascade.assets import asset_path
from pigo_tpu_torch.utils.profiling import FpsMeter, PipelineStats
from pigo_tpu_torch.web.engines import build_argparser, make_engine

PAGE = """<!DOCTYPE html>
<html><head><title>pigo-tpu web demo</title><style>
body { background: #111; color: #eee; font-family: monospace; text-align: center }
canvas { border: 1px solid #444 }
</style></head><body>
<h3>pigo-tpu — browser webcam detection</h3>
<p>keys: <b>c</b> boxes | <b>e</b> pupils | <b>f</b> landmarks &nbsp;
<span id="fps">0</span> FPS &nbsp; <span id="engine"></span></p>
<video id="v" autoplay playsinline style="display:none"></video>
<canvas id="cv" width="640" height="480"></canvas>
<p>No webcam? Watch the server-side stream at <a href="/cam">/cam</a>.
Engine: <a href="/?engine=server">server</a> |
<a href="/?engine=client">client (pico.js, no round trips)</a> |
<a href="/selftest">self-test</a></p>
<script src="/static/pico.js"></script>
<script>
const v = document.getElementById('v'), cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
let show = {c: true, e: true, f: true};
document.addEventListener('keypress', ev => {
  if (ev.key in show) show[ev.key] = !show[ev.key];
});
let last = performance.now(), frames = 0;
function draw(dets) {
  ctx.drawImage(v, 0, 0, cv.width, cv.height);
  ctx.lineWidth = 2;
  for (const d of dets) {
    const f = d.face;
    if (show.c) { ctx.strokeStyle = 'red';
      ctx.strokeRect(f.x || 0, f.y || 0, f.size, f.size); }
    if (show.e) for (const e of (d.eyes || [])) {
      ctx.fillStyle = 'red';
      ctx.beginPath(); ctx.arc(e.x, e.y, 3, 0, 7); ctx.fill(); }
    if (show.f) for (const p of (d.landmark_points || [])) {
      ctx.fillStyle = 'aqua';
      ctx.beginPath(); ctx.arc(p.x, p.y, 2, 0, 7); ctx.fill(); }
  }
  frames++;
  const now = performance.now();
  if (now - last > 1000) {
    document.getElementById('fps').textContent = (frames * 1000 / (now - last)).toFixed(1);
    frames = 0; last = now;
  }
}
// Two engines share the draw path:
//  * server: POST frames to /detect, DEPTH requests pipelined in flight so
//    network+device round trips of consecutive frames overlap.
//  * client: the pure-JS PICO engine (pico.js) detects in-page with no
//    server round trip — the reference WASM surface and its config
//    (MinSize 200, MaxSize 480, shift 0.1, scale 1.1, IoU 0.1, q>50;
//    wasm/detector/detector.go:149-172, canvas.go:196).
const CLIENT = new URLSearchParams(location.search).get('engine') === 'client';
document.getElementById('engine').textContent =
  CLIENT ? 'engine: client (pico.js)' : 'engine: server';
let models = null;
function toJson(r) {
  const d = {face: {x: r.face.col - (r.face.scale >> 1),
                    y: r.face.row - (r.face.scale >> 1), size: r.face.scale}};
  if (r.eyes.length) d.eyes = r.eyes.map(e =>
    ({x: e.col, y: e.row, size: Math.trunc(e.scale)}));
  if (r.landmarks.length) d.landmark_points = r.landmarks.map(p =>
    ({x: p.col, y: p.row, size: Math.trunc(p.scale)}));
  return d;
}
function pumpClient() {
  ctx.drawImage(v, 0, 0, cv.width, cv.height);
  const id = ctx.getImageData(0, 0, cv.width, cv.height);
  const gray = PicoTPU.grayscaleRec709(id.data, cv.width, cv.height);
  const res = PicoTPU.detectAll(models, gray, cv.height, cv.width, {
    minSize: 200, maxSize: 480, shiftFactor: 0.1, scaleFactor: 1.1,
    iouThreshold: 0.1, qThresh: 50.0});
  draw(res.map(toJson));
  setTimeout(pumpClient, 0);
}
const DEPTH = 3;
let inflight = 0;
async function pump() {
  if (inflight >= DEPTH) return;
  inflight++;
  ctx.drawImage(v, 0, 0, cv.width, cv.height);
  const blob = await new Promise(r => cv.toBlob(r, 'image/jpeg', 0.7));
  try {
    const resp = await fetch('/detect', {method: 'POST', body: blob});
    draw(await resp.json());
  } finally {
    inflight--;
    setTimeout(pump, 0);
  }
}
function loop() { while (inflight < DEPTH) pump(); }
navigator.mediaDevices.getUserMedia({video: true}).then(async s => {
  v.srcObject = s;
  if (CLIENT) models = await PicoTPU.loadModels('');
  v.onloadedmetadata = () => CLIENT ? pumpClient() : loop();
}).catch(e => document.body.innerHTML += '<p>webcam unavailable: ' + e + '</p>');
</script></body></html>
"""


def results_to_json(results):
    """Reference JSON schema: x = column of the box corner, y = row."""
    out = []
    for res in results:
        r, c, s, _q = res["face"]
        d = {"face": {"x": c - s // 2, "y": r - s // 2, "size": s}}
        if res["eyes"]:
            d["eyes"] = [
                {"x": int(e[1]), "y": int(e[0]), "size": int(e[2])}
                for e in res["eyes"]
            ]
        if res["landmarks"]:
            d["landmark_points"] = [
                {"x": int(p[1]), "y": int(p[0]), "size": int(p[2])}
                for p in res["landmarks"]
            ]
        out.append(d)
    return out


def annotate(cv2, frame, results):
    for res in results:
        r, c, s = (int(v) for v in res["face"][:3])
        cv2.rectangle(frame, (c - s // 2, r - s // 2), (c + s // 2, r + s // 2),
                      (0, 0, 255), 2)
        for e in res["eyes"]:
            cv2.circle(frame, (int(e[1]), int(e[0])), 3, (0, 0, 255), -1)
        for p in res["landmarks"]:
            cv2.circle(frame, (int(p[1]), int(p[0])), 2, (255, 255, 0), -1)


REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
STATIC_DIR = os.path.join(REPO_ROOT, "examples", "web", "static")


def sample_gray_packet() -> bytes:
    """sample.jpg's exact grayscale plane (u32 rows, u32 cols LE + pixels):
    gives the in-browser self-test a bit-identical frame (canvas JPEG
    decoders differ by +/-1 LSB from PIL, which would break golden parity)."""
    from pigo_tpu_torch.io.image import get_image, rgb_to_grayscale

    img = get_image(asset_path("testdata", "sample.jpg"))
    gray = rgb_to_grayscale(img)
    return struct.pack("<II", img.shape[0], img.shape[1]) + gray.tobytes()


def make_handler(engine, args, lock, stats, meter):
    """The request handler class over `engine`; `lock` serializes the
    engine's calls (None for the cuda-stream engine, whose queue takes
    concurrent calls)."""
    from pigo_tpu_torch.io.image import decode_image

    gray_packet = sample_gray_packet()
    serial = lock if lock is not None else contextlib.nullcontext()

    def detect(frame_bgr):
        with serial:
            return engine.detect(
                frame_bgr, min_size=args.min_size, max_size=args.max_size,
                shift=args.shift, scale=args.scale, iou=args.iou)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # request log like wasm/http/serve.go:45
            sys.stderr.write("%s - %s\n" % (self.address_string(), fmt % a))

        def _send_bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_file(self, path: str, ctype: str):
            if not os.path.isfile(path):
                self.send_error(404)
                return
            with open(path, "rb") as fh:
                self._send_bytes(fh.read(), ctype)

        def do_GET(self):
            # Static client engine + cascade assets (the reference serves
            # /cascade/ the same way, wasm/http/serve.go:17-57).
            if self.path.startswith("/static/"):
                name = os.path.basename(self.path)
                ctype = ("text/javascript" if name.endswith(".js")
                         else "text/html")
                self._send_file(os.path.join(STATIC_DIR, name), ctype)
            elif self.path == "/selftest":
                self._send_file(os.path.join(STATIC_DIR, "selftest.html"),
                                "text/html")
            elif self.path.startswith("/cascade/"):
                parts = [p for p in self.path.split("/")[2:]
                         if p and p not in (".", "..")]
                self._send_file(asset_path("cascade", *parts),
                                "application/octet-stream")
            elif self.path == "/golden/sample.json":
                self._send_file(
                    os.path.join(REPO_ROOT, "tests", "golden", "sample.json"),
                    "application/json")
            elif self.path == "/testdata/sample.gray":
                self._send_bytes(gray_packet, "application/octet-stream")
            elif self.path == "/stats":
                payload = dict(stats.as_dict(), fps=round(meter.value, 1))
                self._send_bytes(json.dumps(payload).encode(),
                                 "application/json")
            elif self.path.split("?", 1)[0] == "/":
                self._send_bytes(PAGE.encode(), "text/html")
            elif self.path == "/cam":
                self._stream_cam()
            else:
                self.send_error(404)

        def _stream_cam(self):
            import cv2

            self.send_response(200)
            self.send_header("Content-Type",
                             "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            cap = cv2.VideoCapture(
                int(args.source) if args.source.isdigit() else args.source)
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    annotate(cv2, frame, detect(frame))
                    ok, jpg = cv2.imencode(".jpg", frame)
                    if not ok:
                        continue
                    self.wfile.write(b"--frame\r\n")
                    self.wfile.write(b"Content-Type: image/jpeg\r\n\r\n")
                    self.wfile.write(jpg.tobytes())
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                cap.release()

        def do_POST(self):
            if self.path != "/detect":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                rgba = decode_image(data)
            except (OSError, ValueError):  # PIL's UnidentifiedImageError too
                self.send_error(400, "bad image")
                return
            frame = rgba[:, :, 2::-1]  # BGR, as the engines take frames
            try:
                with stats.stage("detect", items=1):
                    results = detect(frame)
            except Exception as exc:  # the request fails, the server serves on
                traceback.print_exc()
                self.send_error(500, "detection failed",
                                f"{type(exc).__name__}: {exc}")
                return
            meter.tick()
            self._send_bytes(json.dumps(results_to_json(results)).encode(),
                             "application/json")

    return Handler


def build_parser():
    """The server's flags: build_argparser's, the cuda-stream engine as
    the default, --port and --depth."""
    p = build_argparser(__doc__)
    p.set_defaults(engine="cuda-stream")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--depth", type=int, default=4,
                   help="in-flight frames for the cuda-stream engine")
    return p


def make_server(args, address):
    """The engine `args` name and a ThreadingHTTPServer bound to `address`
    that serves it: (server, engine). The caller runs serve_forever(), then
    server_close() and the engine's close() where it has one."""
    engine = make_engine(
        args.engine, with_pupils=True, with_landmarks=True, depth=args.depth,
        min_size=args.min_size, max_size=args.max_size, shift=args.shift,
        scale=args.scale, iou=args.iou, device=args.device)
    # the cuda-stream engine's queue takes concurrent calls; the others
    # are not re-entrant
    lock = None if args.engine == "cuda-stream" else threading.Lock()
    try:
        srv = ThreadingHTTPServer(address, make_handler(
            engine, args, lock, PipelineStats(), FpsMeter()))
    except BaseException:
        if hasattr(engine, "close"):
            engine.close()
        raise
    return srv, engine


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    srv, engine = make_server(args, ("0.0.0.0", args.port))
    print(f"serving on http://localhost:{args.port}  (engine: {args.engine}; "
          "page: /, stream: /cam, stats: /stats)", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if hasattr(engine, "close"):
            engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
