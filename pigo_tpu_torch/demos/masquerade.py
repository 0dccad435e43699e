"""Masquerade demo: overlay sunglasses on the face, rotated by the pupil
lean angle (the port of examples/masquerade/demo.py; reference
examples/masquerade/puploc.py + puploc.go:66-68).

    python -m pigo_tpu_torch.demos.masquerade --source 0
    python -m pigo_tpu_torch.demos.masquerade \
        --source assets/testdata/sample.jpg --out masq.png --min-size 20
"""

import numpy as np

from pigo_tpu_torch.demos.common import run_demo
from pigo_tpu_torch.web.engines import pupil_lean_angle


def make_sunglasses(width: int) -> np.ndarray:
    """Procedural BGRA sunglasses sprite (the reference ships PNG assets;
    we synthesize one so the demo has no binary fixtures)."""
    import cv2

    h = max(8, width // 3)
    img = np.zeros((h, width, 4), dtype=np.uint8)
    lens_r = h // 2 - 2
    cy = h // 2
    for cx in (width // 4, 3 * width // 4):
        cv2.circle(img, (cx, cy), lens_r, (20, 20, 20, 255), -1)
        cv2.circle(img, (cx, cy), lens_r, (60, 60, 60, 255), 2)
    cv2.line(img, (width // 4 + lens_r, cy), (3 * width // 4 - lens_r, cy),
             (60, 60, 60, 255), 3)
    return img


def overlay_rotated(cv2, frame, sprite, center_rc, angle_deg):
    """Alpha-blend the sprite onto the frame, rotated around its center."""
    sh, sw = sprite.shape[:2]
    m = cv2.getRotationMatrix2D((sw / 2, sh / 2), -angle_deg, 1.0)
    rot = cv2.warpAffine(sprite, m, (sw, sh), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    r0 = int(center_rc[0] - sh / 2)
    c0 = int(center_rc[1] - sw / 2)
    h, w = frame.shape[:2]
    rr0, cc0 = max(0, r0), max(0, c0)
    rr1, cc1 = min(h, r0 + sh), min(w, c0 + sw)
    if rr1 <= rr0 or cc1 <= cc0:
        return
    sub = rot[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0]
    alpha = sub[:, :, 3:4].astype(np.float32) / 255.0
    roi = frame[rr0:rr1, cc0:cc1].astype(np.float32)
    frame[rr0:rr1, cc0:cc1] = (
        alpha * sub[:, :, :3].astype(np.float32) + (1 - alpha) * roi
    ).astype(np.uint8)


def per_frame(cv2, frame, results):
    for res in results:
        if len(res["eyes"]) < 2:
            continue
        left, right = res["eyes"][0], res["eyes"][1]
        angle = pupil_lean_angle(left, right)
        center = ((left[0] + right[0]) / 2.0, (left[1] + right[1]) / 2.0)
        eye_dist = abs(right[1] - left[1])
        sprite = make_sunglasses(max(24, int(eye_dist * 2.2)))
        overlay_rotated(cv2, frame, sprite, center, angle - 90.0)


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv, per_frame, "pigo-tpu masquerade",
                    with_pupils=True, with_landmarks=False, source=source,
                    sink=sink, device=device)


if __name__ == "__main__":
    main()
