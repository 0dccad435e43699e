"""Face anonymization (blur) demo (the port of
examples/facedet/faceblur.py).

    python -m pigo_tpu_torch.demos.faceblur --source 0
    python -m pigo_tpu_torch.demos.faceblur \
        --source assets/testdata/sample.jpg --out blur.png --min-size 20
"""

from pigo_tpu_torch.demos.common import run_demo


def per_frame(cv2, frame, results):
    h, w = frame.shape[:2]
    for res in results:
        r, c, s = (int(v) for v in res["face"][:3])
        r0, r1 = max(0, r - s // 2), min(h, r + s // 2)
        c0, c1 = max(0, c - s // 2), min(w, c + s // 2)
        if r1 > r0 and c1 > c0:
            k = max(3, (s // 8) | 1)  # odd kernel scaled to the face
            frame[r0:r1, c0:c1] = cv2.GaussianBlur(frame[r0:r1, c0:c1],
                                                   (k, k), 0)


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu face blur",
                    with_pupils=False, with_landmarks=False, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
