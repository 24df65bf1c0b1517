"""Offscreen 'swapchain': image readback and save (the port of the JAX
package's ``utils/image_io.py``). A headless renderer presents by copying
the frame to the host and writing it to disk."""

from __future__ import annotations

import numpy as np


def to_uint8(image) -> np.ndarray:
    """Clamp a float image (already display-encoded) to uint8 RGB(A)."""
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, image) -> str:
    """Write `image` as a PNG at `path`, or, where PIL is missing, as a binary
    PPM (RGB) at `path` + ".ppm" unless `path` ends so. Returns the path
    written."""
    arr = to_uint8(image)
    try:
        from PIL import Image
    except ImportError:
        if not path.endswith(".ppm"):
            path = path + ".ppm"
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(np.ascontiguousarray(arr[..., :3]).tobytes())
        return path
    Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "RGB").save(path)
    return path


def read_image(path: str) -> np.ndarray:
    """The (H, W, C) uint8 pixels of a file `save_png` wrote: a PPM is read
    here, any other format through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(b"P6\n"):
        # save_png's header: "P6", "<width> <height>", "255", one a line.
        _, dims, maxval, pixels = data.split(b"\n", 3)
        width, height = map(int, dims.split())
        if int(maxval) != 255:
            raise ValueError(f"{path}: a PPM of maxval {int(maxval)}")
        return np.frombuffer(pixels, np.uint8).reshape(height, width, 3)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)
