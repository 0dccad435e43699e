"""The port's CLI (pigo_tpu_torch.cli) and marker drawing
(pigo_tpu_torch.io.draw) against the JAX package's.

The parser against pigo_tpu.cli's flag for flag; the exit codes of a usage
error and of a file that is no cascade; the JSON of a full run on the
sample image (eyes and landmarks) against the JAX CLI's faces and against
the port's own FaceDetector.detect with the same seed; -json-accumulate;
and the drawn markers against pigo_tpu.io.draw pixel for pixel. Everything
runs in process with device="cpu" (the plain PyTorch versions). Exact
equality is the tolerance throughout.
"""

import json
import os

import numpy as np
import pytest
import torch

from pigo_tpu_torch import cli
from pigo_tpu_torch import detector as port_det
from pigo_tpu_torch.detector import CascadeParams, Detection, FaceResult
from pigo_tpu_torch.models.pupil import Puploc
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(ROOT, "assets", "testdata", "sample.jpg")
CASCADES = ["-cf", os.path.join(ROOT, "assets", "cascade", "facefinder"),
            "-plc", os.path.join(ROOT, "assets", "cascade", "puploc"),
            "-flpc", os.path.join(ROOT, "assets", "cascade", "lps")]
FLAGS = ["-min", "60", "-max", "400", "-shift", "0.3", "-scale", "1.3"]


def _run(argv, capsys):
    rc = cli.main(argv, device="cpu")
    return rc, capsys.readouterr()


def _port_detect(seed=0):
    """The port's FaceDetector.detect at FLAGS on the decoded sample."""
    from pigo_tpu_torch.io.image import get_image, rgb_to_grayscale

    img = get_image(IMAGE)
    det = port_det.FaceDetector(device="cpu")
    return img, det.detect(
        rgb_to_grayscale(img), img.shape[0], img.shape[1],
        CascadeParams(60, 400, 0.3, 1.3), iou_threshold=0.15,
        generator=torch.Generator().manual_seed(seed))


def test_parser_matches_jax_cli():
    """build_parser's 16 flags equal pigo_tpu.cli's: option strings, dest,
    default, type's behaviour and help."""
    from pigo_tpu.cli import build_parser as jax_parser

    def actions(p):
        return [(a.option_strings, a.dest, a.default, a.help, a.nargs)
                for a in p._actions if a.dest != "help"]

    got, want = actions(cli.build_parser()), actions(jax_parser())
    assert got == want and len(got) == 16
    argv = ["-mark", "false", "-min", "33", "-shift", "0.5", "-seed", "4",
            "-json-accumulate"]
    assert vars(cli.build_parser().parse_args(argv)) \
        == vars(jax_parser().parse_args(argv))


def test_usage_and_failure_exit_codes(capsys, tmp_path):
    """No cascade file is a usage error (2); a cascade that content-sniffs
    as an image is a failure (1), as is a landmark directory without the
    pupil cascade; neither writes an output image."""
    rc, out = _run(["-in", IMAGE, "-out", "empty"], capsys)
    assert rc == 2 and "Usage" in out.err
    dest = tmp_path / "out.png"
    rc, out = _run(["-in", IMAGE, "-out", str(dest), "-cf", IMAGE], capsys)
    assert rc == 1 and "not valid" in out.err and not dest.exists()
    rc, out = _run(["-in", IMAGE, "-out", str(dest), "-cf", CASCADES[1],
                    "-flpc", CASCADES[5]], capsys)
    assert rc == 1 and "-plc" in out.err and not dest.exists()


def test_json_matches_jax_and_detect(capsys, tmp_path):
    """The full run's JSON: its face entries equal the JAX CLI's for the
    same image and configuration, and the whole payload equals the port's
    own FaceDetector.detect with torch.Generator().manual_seed(0) (and
    detect_payload's, which needs no Pillow); the annotated image is
    written and decodes to the input's size."""
    from pigo_tpu.cli import main as jax_main

    jax_json = tmp_path / "jax.json"
    assert jax_main(["-in", IMAGE, "-out", "empty", *CASCADES, *FLAGS,
                     "-json", str(jax_json)]) == 0
    capsys.readouterr()
    dest = tmp_path / "out.png"
    rc, out = _run(["-in", IMAGE, "-out", str(dest), *CASCADES, *FLAGS,
                    "-json", "-"], capsys)
    assert rc == 0 and "1 face(s) detected" in out.err
    got = json.loads(out.out)
    want = json.loads(jax_json.read_text())
    assert [f["face"] for f in got] == [f["face"] for f in want]
    assert len(got) == 1 and len(got[0]["landmark_points"]) == 15
    img, results = _port_detect()
    assert got == [r.to_json_dict() for r in results]
    args = cli.build_parser().parse_args(CASCADES + FLAGS)
    _, payload = cli.detect_payload(img, args, device="cpu")
    assert payload == got
    from PIL import Image

    assert Image.open(dest).size == (img.shape[1], img.shape[0])


def test_json_accumulate(capsys, tmp_path):
    """-json-accumulate writes accumulate_json_payload of the per-face
    payload to a file; on two faces side by side the second face carries
    the first face's eyes and points before its own."""
    from PIL import Image

    from pigo_tpu_torch.io.image import get_image

    two = np.concatenate([get_image(IMAGE)] * 2, axis=1)
    src = tmp_path / "two.png"
    Image.fromarray(two).save(src)
    outs = {}
    for extra in ([], ["-json-accumulate"]):
        path = tmp_path / f"{len(extra)}.json"
        rc, _ = _run(["-in", str(src), "-out", "empty", *CASCADES, "-min",
                      "100", "-max", "400", *extra, "-json", str(path)],
                     capsys)
        assert rc == 0
        outs[len(extra)] = json.loads(path.read_text())
    per_face, acc = outs[0], outs[1]
    assert len(per_face) == 2 and per_face[0]["eyes"] != per_face[1]["eyes"]
    assert acc == port_det.accumulate_json_payload(per_face)
    assert acc[1]["eyes"] == per_face[0]["eyes"] + per_face[1]["eyes"]


@pytest.mark.parametrize("angle", [0.0, 0.07])
@pytest.mark.parametrize("marker", ["rect", "circle", "ellipse"])
def test_draw_matches_jax(marker, angle):
    """draw_results of the port equals pigo_tpu.io.draw's pixel for pixel,
    for each marker, with and without the eye boxes, upright and on the
    rotated eye canvas, on the sample's detection and on a hand-made face
    whose eyes and points sit near the image edge."""
    from pigo_tpu.io.draw import draw_results as jax_draw

    from pigo_tpu_torch.io.draw import draw_results

    img, results = _port_detect()
    edge = FaceResult(
        face=Detection(row=30, col=300, scale=70, q=9.0),
        eyes=[Puploc(row=20, col=285, scale=17.5),
              Puploc(row=22, col=318, scale=17.5)],
        landmarks=[Puploc(row=40, col=310 + k, scale=20.0)
                   for k in range(3)])
    results = results + [edge]
    for mark in (True, False):
        got = draw_results(img, results, marker, mark, angle=angle)
        want = jax_draw(img, results, marker, mark, angle=angle)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert not np.array_equal(got[..., :3], img[..., :3])
