"""Parity-diff tooling: compare detection outputs across engines or runs.

The port's copy of pigo_tpu/tools/paritydiff.py (the same `diff`,
`box_iou`, report, `--json` mode and exit codes), on the port's engines
only, so it runs on the card's machine, where the JAX package is not
installed:
  - `cuda`: FaceCascade on the card (the port's kernels);
  - `cpu`: FaceCascade(device="cpu"), the kernels' plain versions;
  - `native`: the port's C++ engine and `native_cluster`;
  - `oracle`: the port's copy of the NumPy oracle.

The canonical detection output is the reference CLI's JSON schema
(cmd/pigo/main.go:89-100). This tool runs any two engines over the same
image (or loads two saved JSON files, such as the `-json` outputs of the
JAX package's CLI and the port's, to compare the two packages) and reports
field-level diffs, the detection-set IoU, and exact/tolerance verdicts.
Exit code 0 when the two are exact or within tolerance, 1 otherwise.

    python -m pigo_tpu_torch.tools.paritydiff --image img.jpg --engines cuda native
    python -m pigo_tpu_torch.tools.paritydiff --json a.json b.json --tol 2
"""

from __future__ import annotations

import argparse
import json
import sys

ENGINES = ("cuda", "cpu", "native", "oracle")


def detections_from_engine(engine: str, image: str, args) -> list[dict]:
    from pigo_tpu_torch.io.image import get_image, rgb_to_grayscale

    img = get_image(image)
    rows, cols = img.shape[0], img.shape[1]
    gray = rgb_to_grayscale(img)
    cfg = dict(min_size=args.min_size, max_size=args.max_size,
               shift_factor=args.shift, scale_factor=args.scale)
    if engine == "native":
        from pigo_tpu_torch.native import NativeFaceCascade, native_cluster

        dets = NativeFaceCascade().run_cascade(gray, rows, cols, **cfg)
        clusters = native_cluster(dets, args.iou)
    elif engine == "oracle":
        from pigo_tpu_torch.cascade.assets import load_facefinder
        from pigo_tpu_torch.oracle.cluster import oracle_cluster_detections
        from pigo_tpu_torch.oracle.face import oracle_run_cascade

        dets = oracle_run_cascade(
            load_facefinder(), gray, rows, cols, cols,
            cfg["min_size"], cfg["max_size"], cfg["shift_factor"],
            cfg["scale_factor"])
        clusters = oracle_cluster_detections(dets, args.iou)
    else:  # cuda, cpu
        from pigo_tpu_torch.models.face import FaceCascade
        from pigo_tpu_torch.ops.cluster import cluster_detections

        fc = FaceCascade(device=None if engine == "cuda" else "cpu")
        dets = fc.run_cascade(gray, rows, cols, **cfg)
        clusters = cluster_detections(dets, args.iou)
    return [
        {"face": {"x": int(c - s // 2), "y": int(r - s // 2),
                  "size": int(s)}, "q": float(q)}
        for r, c, s, q in clusters
    ]


def box_iou(a: dict, b: dict) -> float:
    # the CLI's JSON drops zero fields (Go's omitempty)
    ax0, ay0, asz = (a.get(k, 0) for k in ("x", "y", "size"))
    bx0, by0, bsz = (b.get(k, 0) for k in ("x", "y", "size"))
    ix = max(0, min(ax0 + asz, bx0 + bsz) - max(ax0, bx0))
    iy = max(0, min(ay0 + asz, by0 + bsz) - max(ay0, by0))
    inter = ix * iy
    union = asz * asz + bsz * bsz - inter
    return inter / union if union else 0.0


def diff(a: list[dict], b: list[dict], tol: float) -> dict:
    exact = a == b
    matches = []
    unmatched_b = list(range(len(b)))
    for i, da in enumerate(a):
        best, best_iou = None, 0.0
        for j in unmatched_b:
            v = box_iou(da["face"], b[j]["face"])
            if v > best_iou:
                best, best_iou = j, v
        if best is not None and best_iou > 0.5:
            unmatched_b.remove(best)
            fa, fb = da["face"], b[best]["face"]
            delta = max(abs(fa.get(k, 0) - fb.get(k, 0))
                        for k in ("x", "y", "size"))
            matches.append({"a": i, "b": best, "iou": round(best_iou, 4),
                            "max_coord_delta": delta})
    within_tol = (
        len(matches) == len(a) == len(b)
        and all(m["max_coord_delta"] <= tol for m in matches)
    )
    return {
        "exact": exact,
        "within_tolerance": within_tol,
        "count_a": len(a),
        "count_b": len(b),
        "matched": matches,
        "only_in_a": [i for i in range(len(a))
                      if i not in [m["a"] for m in matches]],
        "only_in_b": unmatched_b,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", help="image to run both engines on")
    p.add_argument("--engines", nargs=2, default=("cuda", "native"),
                   choices=ENGINES)
    p.add_argument("--json", nargs=2, help="two saved JSON files to diff")
    p.add_argument("--tol", type=float, default=0.0,
                   help="max per-coordinate delta for 'within_tolerance'")
    p.add_argument("--min-size", type=int, default=20)
    p.add_argument("--max-size", type=int, default=1000)
    p.add_argument("--shift", type=float, default=0.1)
    p.add_argument("--scale", type=float, default=1.1)
    p.add_argument("--iou", type=float, default=0.2)
    args = p.parse_args(argv)

    if args.json:
        with open(args.json[0]) as fh:
            a = json.load(fh)
        with open(args.json[1]) as fh:
            b = json.load(fh)
    elif args.image:
        a = detections_from_engine(args.engines[0], args.image, args)
        b = detections_from_engine(args.engines[1], args.image, args)
    else:
        p.error("need --image or --json")
    report = diff(a, b, args.tol)
    print(json.dumps(report, indent=2))
    return 0 if report["exact"] or report["within_tolerance"] else 1


if __name__ == "__main__":
    sys.exit(main())
