"""pigo-tpu-torch command-line interface: the port of pigo_tpu/cli.py.

Mirrors the reference CLI flag set and behaviour (cmd/pigo/main.go:105-119)
with the JAX package's CLI's 16 flags, letter for letter:

    pigo-tpu-torch -in input.jpg -out out.png -cf assets/cascade/facefinder \
             -plc assets/cascade/puploc -flpc assets/cascade/lps \
             -min 20 -max 1000 -shift 0.15 -scale 1.15 -angle 0.0 \
             -iou 0.15 -marker rect -mark -json -

`-in -` / `-out -` / `-json -` use stdin/stdout pipes. `-in` also accepts an
http(s) URL. Cascade files are content-sniffed before unpacking
(main.go:301-307). Detections print as the reference's JSON schema.
Detection runs on the CUDA card (`main(device="cpu")` runs the plain
PyTorch versions); `-seed` seeds the `torch.Generator` of
`FaceDetector.detect`'s perturbation draws. The detection between decode
and draw is `detect_payload`, which needs no Pillow.

Exit codes: 0 on success, 2 for a usage error, 1 for a failure.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
import urllib.request

import numpy as np

BANNER = r"""
┌─┐┬┌─┐┌─┐   ┌┬┐┌─┐┬ ┬
├─┘││ ┬│ │───│ ├─┘│ │
┴  ┴└─┘└─┘   ┴ ┴  └─┘

Face detection (PICO cascades) on PyTorch and CUDA.
"""

PIPE = "-"


class CliError(Exception):
    """A failure the CLI reports with exit code 1."""


def detect_file_content_type(path: str) -> str:
    """Sniff like Go's http.DetectContentType over the first 512 bytes
    (utils/utils.go:57-78): binary cascades must be octet-stream."""
    with open(path, "rb") as fh:
        head = fh.read(512)
    for sig, ctype in (
        (b"\xff\xd8\xff", "image/jpeg"),
        (b"\x89PNG\r\n\x1a\n", "image/png"),
        (b"GIF8", "image/gif"),
        (b"%PDF", "application/pdf"),
    ):
        if head.startswith(sig):
            return ctype
    try:
        head.decode("utf-8")
        return "text/plain; charset=utf-8"
    except UnicodeDecodeError:
        return "application/octet-stream"


def is_valid_url(s: str) -> bool:
    return s.startswith("http://") or s.startswith("https://")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pigo-tpu-torch", description=BANNER,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-in", dest="source", default=PIPE, help="Source image")
    p.add_argument("-out", dest="dest", default=PIPE, help="Destination image")
    p.add_argument("-cf", dest="cascade_file", default="",
                   help="Cascade binary file")
    p.add_argument("-min", dest="min_size", type=int, default=20,
                   help="Minimum size of face")
    p.add_argument("-max", dest="max_size", type=int, default=1000,
                   help="Maximum size of face")
    p.add_argument("-shift", dest="shift_factor", type=float, default=0.15,
                   help="Shift detection window by percentage")
    p.add_argument("-scale", dest="scale_factor", type=float, default=1.15,
                   help="Scale detection window by percentage")
    p.add_argument("-angle", type=float, default=0.0,
                   help="0.0 is 0 radians and 1.0 is 2*pi radians")
    p.add_argument("-iou", dest="iou_threshold", type=float, default=0.15,
                   help="Intersection over union (IoU) threshold")
    p.add_argument("-marker", default="rect",
                   help="Detection marker: rect|circle|ellipse")
    p.add_argument("-plc", dest="puploc", default="",
                   help="Pupils/eyes localization cascade file")
    p.add_argument("-flpc", dest="flploc", default="",
                   help="Facial landmark points cascade directory")
    p.add_argument("-mark", dest="mark_eyes", default=True,
                   type=lambda v: v not in ("false", "0", "no"),
                   help="Mark detected eyes")
    p.add_argument("-json", dest="jsonf", default="",
                   help="Output the detection points into a json file")
    p.add_argument("-json-accumulate", dest="json_accumulate",
                   action="store_true",
                   help="Bug-for-bug reference JSON: face i carries the "
                        "eye/landmark points of faces 0..i (the reference "
                        "CLI never resets its coord slices, "
                        "cmd/pigo/main.go:363-365)")
    p.add_argument("-seed", type=int, default=0,
                   help="PRNG seed for the perturbation ensemble")
    return p


def read_source(source: str) -> bytes:
    if is_valid_url(source):
        with urllib.request.urlopen(source) as resp:  # noqa: S310
            return resp.read()
    if source == PIPE:
        if sys.stdin.isatty():
            raise CliError("`-` should be used with a pipe for stdin")
        return sys.stdin.buffer.read()
    with open(source, "rb") as fh:
        return fh.read()


def load_detector(args: argparse.Namespace, device=None):
    """The FaceDetector of the parsed flags' cascades on `device` (the card
    by default). Raises CliError for a file that is no cascade, or for
    landmarks without the pupil cascade."""
    from pigo_tpu_torch.cascade.assets import load_landmark_dir
    from pigo_tpu_torch.detector import FaceDetector
    from pigo_tpu_torch.models.face import FaceCascade
    from pigo_tpu_torch.models.landmark import LandmarkLocalizer
    from pigo_tpu_torch.models.pupil import PupilLocalizer

    if detect_file_content_type(args.cascade_file) \
            != "application/octet-stream":
        raise CliError("the provided cascade classifier is not valid")
    face = FaceCascade.from_file(args.cascade_file, device)
    pupil = landmarks = None
    if args.puploc:
        pupil = PupilLocalizer.from_file(args.puploc, face.device)
    if args.flploc:
        if pupil is None:
            raise CliError(
                "the puploc cascade file is required: use the -plc flag")
        landmarks = LandmarkLocalizer(load_landmark_dir(args.flploc),
                                      face.device)
    return FaceDetector(face=face, pupil=pupil, landmarks=landmarks,
                        with_pupils=pupil is not None,
                        with_landmarks=landmarks is not None,
                        device=face.device)


def detect_payload(img: np.ndarray, args: argparse.Namespace, device=None,
                   detector=None):
    """The CLI's detection of a decoded RGB(A) uint8 [H, W, C] image under
    the parsed flags: (list[FaceResult], the JSON payload). `detector`
    (default: `load_detector(args, device)`) runs `detect` with
    torch.Generator().manual_seed(args.seed)."""
    import torch

    from pigo_tpu_torch.detector import CascadeParams, accumulate_json_payload
    from pigo_tpu_torch.io.image import rgb_to_grayscale

    det = detector if detector is not None else load_detector(args, device)
    rows, cols = img.shape[0], img.shape[1]
    results = det.detect(
        rgb_to_grayscale(img), rows, cols,
        CascadeParams(args.min_size, args.max_size, args.shift_factor,
                      args.scale_factor),
        angle=args.angle, iou_threshold=args.iou_threshold,
        generator=torch.Generator().manual_seed(args.seed))
    payload = [r.to_json_dict() for r in results]
    if args.json_accumulate:
        payload = accumulate_json_payload(payload)
    return results, payload


def write_image(annotated: np.ndarray, dest: str) -> None:
    """Encode the annotated image to `dest` (a file by its extension, or
    JPEG on stdout for `-`). Raises CliError for an unsupported type."""
    from PIL import Image

    out_img = Image.fromarray(annotated)
    if dest == PIPE:
        if sys.stdout.isatty():
            raise CliError("`-` should be used with a pipe for stdout")
        buf = io.BytesIO()
        out_img.convert("RGB").save(buf, format="JPEG", quality=100)
        sys.stdout.buffer.write(buf.getvalue())
        return
    ext = os.path.splitext(dest.lower())[1]
    if ext not in ("", ".jpg", ".jpeg", ".png"):
        raise CliError(f"Output file type not supported: {ext}")
    if ext == ".png":
        out_img.save(dest, format="PNG")
    else:
        out_img.convert("RGB").save(dest, format="JPEG", quality=100)


def main(argv: list[str] | None = None, *, device=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cascade_file:
        print("Usage: pigo-tpu-torch -in input.jpg -out out.png "
              "-cf cascade/facefinder", file=sys.stderr)
        return 2

    from pigo_tpu_torch.io.draw import draw_results
    from pigo_tpu_torch.io.image import decode_image
    from pigo_tpu_torch.utils.spinner import Spinner

    start = time.time()
    spinner = Spinner("Processing...")
    spinner.start()
    try:
        det = load_detector(args, device)
        img = decode_image(read_source(args.source))
        results, payload = detect_payload(img, args, detector=det)
        if args.dest != "empty":
            write_image(draw_results(img, results, args.marker,
                                     args.mark_eyes, angle=args.angle),
                        args.dest)
    except CliError as e:
        # stop BEFORE writing: the spinner thread redraws the current
        # stderr line and its cleanup would erase the message
        spinner.stop()
        print(e, file=sys.stderr)
        return 1
    finally:
        spinner.stop()

    if args.jsonf:
        text = json.dumps(payload)
        if args.jsonf == PIPE:
            print(text)
        else:
            with open(args.jsonf, "w") as fh:
                fh.write(text + "\n")
    n = len(payload)
    if n:
        print(f"\n{n} face(s) detected", file=sys.stderr)
    else:
        print("\nno detected faces!", file=sys.stderr)
    print(f"Execution time: {time.time() - start:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
