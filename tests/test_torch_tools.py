"""The port's parity tools against the JAX package's: the NumPy oracle
(pigo_tpu_torch.oracle), make_golden and paritydiff (pigo_tpu_torch.tools).

The oracle copy equals pigo_tpu.oracle bit for bit (the face pass upright
and rotated on the golden sample frame, the pupil walks on seeded starts,
the clustering on seeded detections); make_golden rebuilds the committed
tests/golden/sample.json exactly; paritydiff finds the port's plain
version exact against its C++ engine and its oracle on the sample image,
and the JAX CLI's -json output exact against the port CLI's, with the
tool's exit codes. Everything runs on the CPU (device="cpu"). Exact
equality is the tolerance throughout.
"""

import argparse
import json
import os

import numpy as np
import pytest

from pigo_tpu_torch import oracle
from pigo_tpu_torch.cascade.assets import (load_facefinder,
                                           load_landmark_dir, load_puploc)
from pigo_tpu_torch.tools import make_golden, paritydiff
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(ROOT, "assets", "testdata", "sample.jpg")
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the golden corpus's configuration (tests/golden/sample.json)
REF_ARGS = ["--shift", "0.2", "--iou", "0.1"]


@pytest.fixture(scope="module")
def golden_frame():
    with open(os.path.join(GOLDEN, "sample.json")) as fh:
        golden = json.load(fh)
    gray, rows, cols, dim = make_golden.fixture_frame(golden["image"])
    return golden, gray, rows, cols, dim


@pytest.mark.parametrize("angle", [0.0, 0.07])
def test_oracle_face_matches_jax(golden_frame, angle):
    from pigo_tpu.cascade.assets import load_facefinder as jax_facefinder
    from pigo_tpu.oracle.face import oracle_run_cascade as jax_run

    golden, gray, rows, cols, dim = golden_frame
    c = golden["config"]
    args = (gray, rows, cols, dim, c["min_size"], c["max_size"],
            c["shift_factor"], c["scale_factor"])
    got = oracle.oracle_run_cascade(load_facefinder(), *args, angle=angle)
    want = jax_run(jax_facefinder(), *args, angle=angle)
    assert got.shape[0] >= 4 and np.array_equal(got, want)
    if angle == 0.0:  # the scalar transliteration, window by window
        for r, cc, s, q in got[:2]:
            assert oracle.oracle_run_cascade_scalar(
                load_facefinder(), gray, rows, cols, dim, int(r), int(cc),
                int(s)) == q


@pytest.mark.parametrize("flip_v", [False, True])
@pytest.mark.parametrize("angle", [0.0, 0.07])
def test_oracle_pupil_matches_jax(golden_frame, angle, flip_v):
    """The regression walks and the voted detector on 63 seeded starts of
    the puploc and of one landmark cascade."""
    from pigo_tpu.cascade.assets import load_landmark_dir as jax_lps
    from pigo_tpu.cascade.assets import load_puploc as jax_puploc
    from pigo_tpu.oracle import pupil as jax_pupil

    _, gray, rows, cols, dim = golden_frame
    rng = np.random.default_rng(7)
    u = rng.random((63, 3), dtype=np.float32)
    starts = oracle.pupil.make_perturbations(190.0, 110.0, 60.0, u)
    assert all(np.array_equal(a, b) for a, b in zip(
        starts, jax_pupil.make_perturbations(190.0, 110.0, 60.0, u)))
    for port_f, jax_f in ((load_puploc(), jax_puploc()),
                          (load_landmark_dir()["lp44"], jax_lps()["lp44"])):
        if angle > 0.0:
            got = oracle.oracle_pupil_rotated_walk(
                port_f, *starts, angle, rows, cols, gray, dim, flip_v)
            want = jax_pupil.oracle_pupil_rotated_walk(
                jax_f, *starts, angle, rows, cols, gray, dim, flip_v)
        else:
            got = oracle.oracle_pupil_walk(port_f, *starts, rows, cols, gray,
                                           dim, flip_v)
            want = jax_pupil.oracle_pupil_walk(jax_f, *starts, rows, cols,
                                               gray, dim, flip_v)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert oracle.oracle_run_detector(
            port_f, starts, rows, cols, gray, dim, angle, flip_v) \
            == jax_pupil.oracle_run_detector(
                jax_f, starts, rows, cols, gray, dim, angle, flip_v)


@pytest.mark.parametrize("iou", [0.1, 0.2, 0.5])
def test_oracle_cluster_matches_jax(iou):
    from pigo_tpu.oracle.cluster import oracle_cluster_detections as jax_cl

    rng = np.random.default_rng(3)
    n = 200
    dets = np.stack([rng.integers(20, 380, n), rng.integers(20, 300, n),
                     rng.integers(20, 120, n),
                     rng.uniform(0.1, 9.0, n).astype(np.float32)],
                    axis=1).astype(np.float64)
    got = oracle.oracle_cluster_detections(dets, iou)
    assert got.shape[0] >= 2
    assert np.array_equal(got, jax_cl(dets, iou))
    assert oracle.oracle_cluster_detections(dets[:0], iou).shape == (0, 4)


def test_make_golden_rebuilds_the_committed_sample(tmp_path, capsys,
                                                   monkeypatch):
    """main writes each fixture (here only the sample's) into the directory
    it is given, equal to the committed tests/golden/sample.json; it needs
    that directory."""
    monkeypatch.setattr(make_golden, "FIXTURES", make_golden.FIXTURES[:1])
    assert make_golden.main([str(tmp_path)]) == 0
    assert "sample.json" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["sample.json"]
    with open(tmp_path / "sample.json") as fh:
        got = json.load(fh)
    with open(os.path.join(GOLDEN, "sample.json")) as fh:
        assert got == json.load(fh)
    assert got["faces"] and len(got["faces"][0]["landmarks"]) == 15
    with pytest.raises(SystemExit) as exc:
        make_golden.main([])
    assert exc.value.code == 2


@pytest.mark.parametrize("other", ["native", "oracle"])
def test_paritydiff_cpu_against_native_and_oracle(other, capsys):
    """The port's plain version, its C++ engine and its oracle agree
    exactly on the sample image at the golden configuration (exit 0)."""
    rc = paritydiff.main(["--image", IMAGE, "--engines", "cpu", other,
                          *REF_ARGS])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["exact"]
    assert report["count_a"] == report["count_b"] >= 1


def test_paritydiff_cuda_needs_a_card():
    """The `cuda` engine runs the kernels or raises: no quiet CPU run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")  # pragma: no cover
    args = argparse.Namespace(min_size=20, max_size=1000, shift=0.2,
                              scale=1.1, iou=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paritydiff.detections_from_engine("cuda", IMAGE, args)


def test_paritydiff_json_of_the_two_clis(tmp_path, capsys):
    """--json on the JAX CLI's and the port CLI's -json outputs for the
    sample image: exact (exit 0); a face moved by 3 px is not exact (exit
    1) but within --tol 3 (exit 0); a face missing fails (exit 1)."""
    from pigo_tpu.cli import main as jax_cli
    from pigo_tpu.tools.paritydiff import diff as jax_diff
    from pigo_tpu_torch.cli import main as port_cli

    cascades = ["-cf", os.path.join(ROOT, "assets", "cascade", "facefinder")]
    flags = ["-in", IMAGE, "-out", "empty", *cascades, "-min", "60", "-max",
             "400", "-shift", "0.3", "-scale", "1.3"]
    a, b = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_cli([*flags, "-json", str(a)]) == 0
    assert port_cli([*flags, "-json", str(b)], device="cpu") == 0
    capsys.readouterr()

    def run(*argv):
        rc = paritydiff.main(list(argv))
        return rc, json.loads(capsys.readouterr().out)

    rc, report = run("--json", str(a), str(b))
    assert rc == 0 and report["exact"] and report["count_a"] >= 1
    faces = json.loads(b.read_text())
    assert report == jax_diff(json.loads(a.read_text()), faces, 0.0)
    faces[0]["face"]["x"] += 3
    moved = tmp_path / "moved.json"
    moved.write_text(json.dumps(faces))
    rc, report = run("--json", str(a), str(moved))
    assert rc == 1 and not report["exact"]
    assert report["matched"][0]["max_coord_delta"] == 3
    rc, report = run("--json", str(a), str(moved), "--tol", "3")
    assert rc == 0 and report["within_tolerance"]
    moved.write_text(json.dumps(faces[1:]))
    rc, report = run("--json", str(a), str(moved), "--tol", "3")
    assert rc == 1 and report["only_in_a"] == [0]


def test_paritydiff_diff_reads_omitted_zero_fields():
    """The CLI's JSON drops zero fields (Go's omitempty): a face at x = 0
    compares as x = 0; otherwise diff and box_iou equal the JAX tool's."""
    from pigo_tpu.tools import paritydiff as jax_tool

    a = [{"face": {"x": 10, "y": 20, "size": 40}, "q": 3.0},
         {"face": {"x": 200, "y": 20, "size": 60}, "q": 5.0}]
    b = [{"face": {"x": 12, "y": 20, "size": 40}, "q": 3.0}]
    for tol in (0.0, 2.0):
        assert paritydiff.diff(a, b, tol) == jax_tool.diff(a, b, tol)
    assert paritydiff.box_iou(a[0]["face"], b[0]["face"]) \
        == jax_tool.box_iou(a[0]["face"], b[0]["face"])
    edge = [{"face": {"y": 20, "size": 40}}]
    report = paritydiff.diff(edge, [{"face": {"x": 0, "y": 20,
                                              "size": 40}}], 0.0)
    assert report["within_tolerance"] and not report["exact"]
    assert report["matched"][0]["max_coord_delta"] == 0
