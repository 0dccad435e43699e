"""The realtime demos on the port's engines.

The counterpart of the JAX package's `examples/` demos, one module each:
`facedet` (face boxes), `faceblur` (faces blurred), `puploc` (pupils),
`facial_landmark` (the 15 landmark points), `blinkdet` (blinks, from a
Hough-circle iris check at each pupil), `masquerade` (a sunglasses sprite
turned by the pupils' lean angle) and `talk_detector` (the mouth aspect
ratio). Each runs as `python -m pigo_tpu_torch.demos.<name>`, on the card
through `FaceDetector.detect` (`--engine cuda`, the default) or on the
host C++ engine (`--engine native`); `common` holds their frame source,
sink, drawing and loop. Importing a module here starts nothing and loads
neither OpenCV nor Pillow: OpenCV is imported where a frame is read,
drawn or written.
"""
