"""Realtime face detection demo (the port of examples/facedet/demo.py).

    python -m pigo_tpu_torch.demos.facedet --source 0              # webcam
    python -m pigo_tpu_torch.demos.facedet --source video.mp4
    python -m pigo_tpu_torch.demos.facedet \
        --source assets/testdata/sample.jpg --out facedet.png --min-size 20
"""

from pigo_tpu_torch.demos.common import draw_face_box, run_demo


def per_frame(cv2, frame, results):
    for res in results:
        draw_face_box(cv2, frame, res["face"])


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu face detection",
                    with_pupils=False, with_landmarks=False, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
