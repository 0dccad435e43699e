"""Facial landmark points demo (the port of
examples/facial_landmark/demo.py).

Draws the 15-point landmark set (5 eye cascades x2 flips, 4 mouth, nose).

    python -m pigo_tpu_torch.demos.facial_landmark --source 0
    python -m pigo_tpu_torch.demos.facial_landmark \
        --source assets/testdata/sample.jpg --out flp.png --min-size 20
"""

from pigo_tpu_torch.demos.common import draw_face_box, draw_point, run_demo


def per_frame(cv2, frame, results):
    for res in results:
        draw_face_box(cv2, frame, res["face"])
        for eye in res["eyes"]:
            draw_point(cv2, frame, eye, color=(0, 0, 255))
        for pt in res["landmarks"]:
            draw_point(cv2, frame, pt, color=(255, 0, 0), radius=3)


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu facial landmarks",
                    with_pupils=True, with_landmarks=True, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
