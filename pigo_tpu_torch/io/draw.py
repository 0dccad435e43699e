"""Detection marker drawing (PIL), mirroring the reference CLI's gg drawing.

Reference: cmd/pigo/main.go drawFaces (:359-574) and
drawEyeDetectionMarker (:608-619). Markers: rect | circle | ellipse, red
2px stroke; eye dots red filled radius 0.15*scale (plus an optional yellow
box); landmark dots blue at half scale.

For angle > 0 the reference draws each eye marker on a transparent
face-sized scratch canvas (at the eye's offset from the face center,
translated to the canvas center), rotates that canvas by ``2*(angle*180/pi)``
degrees — the reference converts its fraction-of-2*pi angle as if it were
radians, a quirk replicated as-is — flips it horizontally, and composites it
at the face box's top-left corner (main.go:424-480). The scratch canvas
accumulates across the two eyes (the left-eye dot is composited again with
the right eye's pass), and landmark dots are always drawn upright.

The port's copy of pigo_tpu/io/draw.py. Pillow is imported inside
`draw_results`, as io/image.py imports it, so the package imports without
it.
"""

from __future__ import annotations

import math

import numpy as np

RED = (255, 0, 0, 255)
BLUE = (0, 0, 255, 255)
YELLOW = (255, 255, 0, 255)

MARKER_RECTANGLE = "rect"
MARKER_CIRCLE = "circle"
MARKER_ELLIPSE = "ellipse"


def _eye_marker(dc, col: float, row: float, scale: float,
                mark_eyes: bool) -> None:
    """Red pupil dot + optional yellow zone box (main.go:608-619)."""
    r = scale * 0.15
    dc.ellipse([col - r, row - r, col + r, row + r], fill=RED)
    if mark_eyes:
        rr = scale * 1.5
        dc.rectangle([col - rr, row - rr, col + rr, row + rr],
                     outline=YELLOW, width=2)


def draw_results(
    image: np.ndarray,  # RGBA/RGB uint8 [H, W, C]
    results,  # list[FaceResult]
    marker: str = MARKER_RECTANGLE,
    mark_eyes: bool = True,
    angle: float = 0.0,  # fraction of 2*pi, the CLI -angle unit
) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(image)).convert("RGBA")
    dc = ImageDraw.Draw(img)
    for res in results:
        f = res.face
        x, y, s = f.col, f.row, f.scale
        if marker == MARKER_CIRCLE:
            dc.ellipse([x - s / 2, y - s / 2, x + s / 2, y + s / 2],
                       outline=RED, width=2)
        elif marker == MARKER_ELLIPSE:
            dc.ellipse([x - s / 2, y - s / 1.6, x + s / 2, y + s / 1.6],
                       outline=RED, width=2)
        else:
            dc.rectangle([x - s / 2, y - s / 2, x + s / 2, y + s / 2],
                         outline=RED, width=2)
        if angle > 0 and res.eyes:
            # Rotated eye overlay: scratch canvas shared by both eyes,
            # re-rotated + mirrored + composited once per detected eye
            # (reference main.go:424-480, incl. its radians-vs-fraction
            # unit quirk: degrees = 2 * angle * 180 / pi).
            zone = Image.new("RGBA", (int(s), int(s)), (0, 0, 0, 0))
            zdc = ImageDraw.Draw(zone)
            degrees = 2.0 * (angle * 180.0 / math.pi)
            corner = (int(x - s / 2), int(y - s / 2))
            for eye in res.eyes:
                _eye_marker(zdc,
                            s / 2 - (x - eye.col),
                            s / 2 - (y - eye.row),
                            eye.scale, mark_eyes)
                rotated = zone.rotate(degrees, expand=True,
                                      resample=Image.BILINEAR)
                final = rotated.transpose(Image.FLIP_LEFT_RIGHT)
                img.alpha_composite(final, corner)
        else:
            for eye in res.eyes:
                _eye_marker(dc, eye.col, eye.row, eye.scale, mark_eyes)
        for p in res.landmarks:
            r = (p.scale * 0.5) * 0.15
            dc.ellipse([p.col - r, p.row - r, p.col + r, p.row + r], fill=BLUE)
    return np.asarray(img)
