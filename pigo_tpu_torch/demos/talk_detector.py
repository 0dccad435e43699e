"""Talk detection demo (the port of examples/talk_detector/demo.py).

Computes the mouth aspect ratio from the mouth landmark points; a ratio
below the threshold means the mouth is open ("talking") — the reference's
`mar = (dist1/dist2) * 0.19 < 0.4` heuristic (talkdet.go:105-122).

    python -m pigo_tpu_torch.demos.talk_detector --source 0
    python -m pigo_tpu_torch.demos.talk_detector --source video.mp4 \
        --out talk.mp4

The mouth points are taken by position, as the JAX demo takes them: the
detectors drop every point at row or col <= 0, so when one of the first
ten points is dropped, MOUTH_SLICE takes a shifted point as a mouth point.
"""

import math

from pigo_tpu_torch.demos.common import draw_face_box, draw_point, run_demo
from pigo_tpu_torch.web.engines import MOUTH_CASCADES

MAR_SCALE = 0.19
MAR_THRESHOLD = 0.4

# landmark list layout (web.engines.NativeEngine._landmarks, FaceDetector):
# 10 eye points, then the 4 mouth points (lp81, lp82, lp84, lp93), then the
# flipped nose.
MOUTH_SLICE = slice(10, 10 + len(MOUTH_CASCADES))


def mouth_aspect_ratio(mouth_pts) -> float:
    """dist(lp82, nose-flip) / dist(lp84, lp93) * 0.19, mirroring the point
    pairs the reference picks out of its accumulated mouth list."""
    if len(mouth_pts) < 4:
        return float("inf")
    p1, p3 = mouth_pts[1], mouth_pts[2]
    p2, p4 = mouth_pts[-1], mouth_pts[-2]
    dist1 = math.hypot(p2[0] - p1[0], p2[1] - p1[1])
    dist2 = math.hypot(p4[0] - p3[0], p4[1] - p3[1])
    if dist2 == 0:
        return float("inf")
    return dist1 / dist2 * MAR_SCALE


def per_frame(cv2, frame, results):
    for res in results:
        draw_face_box(cv2, frame, res["face"])
        pts = res["landmarks"]
        mouth = pts[MOUTH_SLICE] + pts[-1:]  # 4 mouth points + flipped nose
        for pt in mouth:
            draw_point(cv2, frame, pt, color=(255, 0, 0), radius=3)
        if mouth_aspect_ratio(mouth) < MAR_THRESHOLD:
            cv2.putText(frame, "Talking!", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.9, (0, 0, 255), 2)


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu talk detector",
                    with_pupils=True, with_landmarks=True, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
