"""Pupil/eye localization demo (the port of examples/puploc/demo.py).

    python -m pigo_tpu_torch.demos.puploc --source 0
    python -m pigo_tpu_torch.demos.puploc --source assets/testdata/sample.jpg \
        --out puploc.png --min-size 20
"""

from pigo_tpu_torch.demos.common import draw_face_box, draw_point, run_demo


def per_frame(cv2, frame, results):
    for res in results:
        draw_face_box(cv2, frame, res["face"])
        for eye in res["eyes"]:
            draw_point(cv2, frame, eye, color=(0, 0, 255))


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu pupil localization",
                    with_pupils=True, with_landmarks=False, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
