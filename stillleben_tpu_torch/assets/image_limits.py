"""The image sizes Pillow and OpenCV refuse when they open a file.

Each decoder calls ``check_size`` once its header is parsed, before it
decodes or allocates a pixel, so a header that claims a huge image costs
nothing:

- Pillow's reading (``read_image``): ``Image.open`` raises
  ``DecompressionBombError`` for more than ``2 * Image.MAX_IMAGE_PIXELS``
  pixels (``PIL_MAX_PIXELS``), whatever the format.
- OpenCV's reading (``read_image_cv2``): ``cv2.imread`` raises for a side
  over ``CV_IO_MAX_IMAGE_WIDTH`` / ``_HEIGHT`` (2^20) or more than
  ``CV_IO_MAX_IMAGE_PIXELS`` (2^30) pixels.

The port raises ``ValueError`` where either library raises.
"""

from __future__ import annotations

PIL_MAX_PIXELS = 2 * 89478485
CV2_MAX_SIDE = 1 << 20
CV2_MAX_PIXELS = 1 << 30


def check_size(width: int, height: int, name: str, fmt: str, cv2: bool = False) -> None:
    """Raise ``ValueError`` for a ``width`` x ``height`` image that Pillow
    (or, with ``cv2``, OpenCV) refuses to open."""
    if cv2:
        if not (0 < width <= CV2_MAX_SIDE and 0 < height <= CV2_MAX_SIDE
                and width * height <= CV2_MAX_PIXELS):
            raise ValueError(f"{name}: a {fmt} of {width}x{height} pixels is over OpenCV's "
                             f"limits ({CV2_MAX_SIDE} a side, {CV2_MAX_PIXELS} pixels)")
    elif max(1, width) * max(1, height) > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: a {fmt} of {width}x{height} pixels is over Pillow's "
                         f"decompression bomb limit of {PIL_MAX_PIXELS}")
