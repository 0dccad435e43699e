"""The benchmark's own tests, on the CPU with the program's plain kernels.

    python -m pytest pigobench/tests -q

A run here passes `--device cpu`, which skips the look for a card; cells
of a small test configuration (400x320 frames) are added as new files in
a copy of the tree, as a later change would add them. Nothing here needs
the card.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from pigobench.lib import imports, manifest  # noqa: E402

TINY_CONFIG = {
    "name": "tiny", "image": "pigobench/data/sample_gray.npy",
    "frame": [400, 320],
    "params": {"min_size": 100, "max_size": 400, "shift_factor": 0.1,
               "scale_factor": 1.1, "iou_threshold": 0.2},
}


def _traffic(driver, **extra):
    return {"driver": driver, "pool": {"frames": 2, "pool_seed": 5,
                                       "roll_rows": 8, "noise": 1},
            "warmup_s": 0.5, "trace_frames": 2,
            "check": {"keep_share": 1.0, "sample": 3}, **extra}


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark with a test configuration, two test mixes, a
    test metric and their cells added as new files and entries; the
    program and the assets are linked in."""
    shutil.copytree(BENCH, tmp_path / "pigobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("pigo_tpu_torch", "assets"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    real = json.load(open(os.path.join(BENCH, "configs", "webcam-480p.json")))
    cfg = dict(real, **TINY_CONFIG)
    (tmp_path / "pigobench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "pigobench/traffic/tinydetect.json").write_text(
        json.dumps(_traffic("serial")))
    (tmp_path / "pigobench/traffic/tinystream.json").write_text(
        json.dumps(_traffic("device_stream", depth=2)))
    (tmp_path / "pigobench/metrics/tiny.answers.py").write_text(
        "def read(ctx):\n    return ctx.window['answers']\n")
    m["configs"].append({"name": "tiny", "source": "test", "file":
                         "pigobench/configs/tiny.json", "reduced": [],
                         "why": "test"})
    cells = ["tiny.detect", "tiny.stream"]
    for c, t in zip(cells, ("tinydetect", "tinystream")):
        m["workloads"].append({"name": c, "config": "tiny", "traffic": t,
                               "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "tiny.answers", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": cells})
    for e in m["per_layer"]:
        e["workloads"] = e["workloads"] + cells
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path


def run(root, workload, *extra, seconds="1", trace="0", prelude=""):
    """One run of the harness at `root` on the CPU: (exit code, the last
    stdout line as JSON or None, stderr). `prelude` is Python run first in
    the same process, to break the program underneath."""
    args = ["--workload", workload, "--seed", "2147483659", "--seconds",
            seconds, "--trace", trace, "--device", "cpu", *extra]
    code = (f"import sys; sys.path.insert(0, {str(root)!r})\n{prelude}\n"
            "from pigobench.lib import harness\n"
            f"sys.exit(harness.main({args!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-1]) if lines else None), \
        proc.stderr


def test_manifest_resolves_by_name():
    m = manifest.load()
    assert manifest.problems(m) == []
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        assert os.path.isfile(cell.driver_path)
        for e in cell.end_to_end + cell.per_layer:
            assert callable(cell.metric(e["name"]).read)
        assert {e["name"] for e in cell.end_to_end} >= {"setup_s",
                                                       "frames_per_s"}
        assert cell.per_layer


def test_manifest_keys_names_and_units():
    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pigobench/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert 0.01 <= e["bound"] <= 0.25
    layers = set()
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert e["moves"] in {x["name"] for x in m["end_to_end"]}
        layers.add(e["layer"])
        for w in e.get("workloads", []):
            moved = [x for x in m["end_to_end"] if x["name"] == e["moves"]]
            assert manifest.applies(moved[0], w)
    for e in m["end_to_end"] + m["per_layer"]:
        assert manifest.NAME_RE.fullmatch(e["name"])
        assert manifest.UNIT_RE.fullmatch(e["unit"])
        assert e["better"] in ("lower", "higher")
    assert not manifest.NAME_RE.fullmatch("frames per s")
    assert not manifest.UNIT_RE.fullmatch("frames per s")
    assert not manifest.UNIT_RE.fullmatch("µs")


def test_import_check_compares_whole_top_level_names():
    assert imports.forbidden(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax", "pigo_tpu", "pigo_tpu.detector"]) == \
        sorted(["jax", "jax.numpy", "jaxlib.xla_client", "flax", "pigo_tpu",
                "pigo_tpu.detector"])
    assert imports.forbidden(["pigo_tpu_torch", "pigo_tpu_torch.detector",
                              "jaxtyping", "pigobench", "numpy"]) == []


def test_reference_loads_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                for mod in mods:
                    assert mod.split(".")[0] not in {
                        "pigo_tpu_torch", "pigo_tpu", "jax", "jaxlib"}, mod
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import pigobench.reference.pico\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"pigo_tpu_torch", "pigo_tpu", "jax", "jaxlib"}


@pytest.mark.parametrize("workload", ["tiny.detect", "tiny.stream"])
def test_cell_runs_and_is_correct(tree, workload):
    rc, res, err = run(tree, workload)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert list(res)[-1] == "checks"
    assert res["attempted"] == res["metrics"]["tiny.answers"]["value"] > 0
    assert set(res["metrics"]) >= {"frames_per_s", "setup_s", "tiny.answers"}
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_layers_and_breakdown(tree):
    rc, res, err = run(tree, "tiny.detect", trace="1")
    assert rc == 0, err
    assert res["correct"] is True
    # the CPU has no device trace, so no per-layer metric has a reading
    assert res["metrics"] == {}
    assert "device_ops" in res["breakdown"]


@pytest.mark.parametrize("workload", ["webcam-480p.detect"])
def test_real_cell_runs_on_the_cpu(workload):
    rc, res, err = run(ROOT, workload)
    assert rc == 0, err
    assert res["correct"] is True, err


FAULTS = {
    # an answer altered where it is produced: every face's score
    "face_altered": ("faces_wrong", """
import pigo_tpu_torch.detector as d
_detect = d.FaceDetector.detect
def detect(self, *a, **k):
    out = _detect(self, *a, **k)
    for r in out:
        r.face = d.Detection(r.face.row, r.face.col, r.face.scale,
                             r.face.q + 1e-3)
    return out
d.FaceDetector.detect = detect
"""),
    # a landmark point altered where it is produced
    "point_altered": ("points_wrong", """
import pigo_tpu_torch.detector as d
_attach = d._attach_post
def attach(res, *a, **k):
    _attach(res, *a, **k)
    if res.landmarks:
        res.landmarks[0].row += 1
d._attach_post = attach
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_program_is_not_correct(tree, fault):
    number, prelude = FAULTS[fault]
    rc, res, err = run(tree, "tiny.detect", prelude=prelude)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"][number]["value"] > 0


def test_stream_that_drops_half_its_frames_is_not_correct(tree):
    prelude = """
import pigo_tpu_torch.detector as d
_stream = d.FaceDetector.detect_stream_device
def stream(self, *a, **k):
    for k_, res in enumerate(_stream(self, *a, **k)):
        if k_ % 2 == 0:
            yield res
d.FaceDetector.detect_stream_device = stream
"""
    rc, res, err = run(tree, "tiny.stream", prelude=prelude)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["answers_missing"]["value"] > 0


@pytest.mark.parametrize("workload", ["tiny.detect", "tiny.stream"])
def test_control_in_bfloat16_is_not_correct(tree, workload):
    """The reference in bfloat16 in the program's place, judged by the
    run's own comparison."""
    rc, res, err = run(tree, workload, "--control", "bfloat16")
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["faces_wrong"]["value"] > 0
    assert res["attempted"] > 0


def test_control_in_float32_is_correct(tree):
    """The same stand-in in the configuration's own precision passes: what
    fails the control is its precision."""
    rc, res, err = run(tree, "tiny.detect", "--control", "float32")
    assert rc == 0, err
    assert res["correct"] is True, err
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_no_result_once_jax_loads_after_the_window(tree):
    """A module named `jax` loaded by a metric reader, after the window and
    the reference, still stops the result line."""
    m = json.loads((tree / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "tiny.loads_jax", "unit": "1",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny.detect"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(m))
    (tree / "stub" / "jax").mkdir(parents=True)
    (tree / "stub" / "jax" / "__init__.py").write_text("")
    (tree / "pigobench/metrics/tiny.loads_jax.py").write_text(
        "import os, sys\n"
        "sys.path.insert(0, os.path.join(os.getcwd(), 'stub'))\n"
        "import jax  # noqa: F401\n\n\n"
        "def read(ctx):\n    return 1.0\n")
    rc, res, err = run(tree, "tiny.detect")
    assert rc != 0
    assert res is None
    assert "jax" in err.strip().splitlines()[-1]


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "pigobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "pigobench/run.py", "--workload",
         "webcam-480p.detect", "--seed", "1", "--seconds", "1", "--trace",
         "0", "--device", "cpu"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_a_card():
    """On a host without CUDA (this one) the default device refuses."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "pigobench/run.py", "--workload",
         "webcam-480p.detect", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
