"""Blink detection demo (the port of examples/blinkdet/demo.py).

Like the reference, a blink is flagged when a localized pupil position stops
yielding a Hough-circle (iris) match for a few consecutive frames on one side.

    python -m pigo_tpu_torch.demos.blinkdet --source 0
    python -m pigo_tpu_torch.demos.blinkdet --source video.mp4 --out blink.mp4

The blink counters belong to one run (`new_state`): every `main` starts
with both sides open. The JAX demo keeps them in a module-level dict, so
there a second run in one process starts from the first one's counts.
"""

import functools

from pigo_tpu_torch.demos.common import draw_face_box, draw_point, run_demo

EYE_CLOSED_CONSEC_FRAMES = 2


def new_state() -> dict:
    """One run's counters: frames in a row with the iris seen, per side."""
    return {"left": EYE_CLOSED_CONSEC_FRAMES,
            "right": EYE_CLOSED_CONSEC_FRAMES}


def iris_visible(cv2, frame, eye) -> bool:
    """HoughCircles iris check around the localized pupil (reference
    blinkdet.py:84-96)."""
    r, c, s = int(eye[0]), int(eye[1]), max(4, int(eye[2]))
    pad = int(s * 1.2)
    sub = frame[max(0, r - pad):r + pad, max(0, c - pad):c + pad]
    if sub.size == 0:
        return False
    gray = cv2.cvtColor(sub, cv2.COLOR_BGR2GRAY)
    max_radius = max(5, int(s * 0.45))
    circles = cv2.HoughCircles(
        cv2.medianBlur(gray, 1), cv2.HOUGH_GRADIENT, 1, max_radius,
        param1=60, param2=21, minRadius=4, maxRadius=max_radius)
    return circles is not None


def per_frame(cv2, frame, results, state):
    """Draw one frame and update `state` (new_state's counters)."""
    for res in results:
        draw_face_box(cv2, frame, res["face"])
        face_col = res["face"][1]
        for eye in res["eyes"]:
            side = "left" if eye[1] < face_col else "right"
            if iris_visible(cv2, frame, eye):
                state[side] += 1
            else:
                state[side] = 0
            draw_point(cv2, frame, eye, color=(0, 0, 255))
        if state["left"] < EYE_CLOSED_CONSEC_FRAMES:
            cv2.putText(frame, "Left blink!", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 255), 2)
        if state["right"] < EYE_CLOSED_CONSEC_FRAMES:
            cv2.putText(frame, "Right blink!", (frame.shape[1] - 150, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 255), 2)


def main(argv=None, *, source=None, sink=None, device=None):
    return run_demo(__doc__, argv,
                    functools.partial(per_frame, state=new_state()),
                    "pigo-tpu blink detector", with_pupils=True,
                    with_landmarks=False, source=source, sink=sink,
                    device=device)


if __name__ == "__main__":
    main()
