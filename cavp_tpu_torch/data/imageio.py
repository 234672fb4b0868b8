"""Frame and mask decoding and encoding: PIL, the JAX package's decoder.

The port reads and writes images with PIL (Pillow) and nothing else, on
the CPU test machine and on the card's host alike, so its frames are the
bytes the JAX package's PIL path decodes. There is no second decoder to
fall back on: without PIL every call here raises, naming it. PIL is
imported at the first call, not with the module.
"""

from __future__ import annotations

import numpy as np

DECODER = "PIL"


def pil_image():
    """PIL's ``Image`` module; raises ``RuntimeError`` when PIL is missing."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "the port decodes frames and masks with PIL (Pillow), which is not "
            "installed on this machine") from exc
    return Image


def decoder_name() -> str:
    """``"PIL <version>"``."""
    pil_image()
    import PIL

    return f"{DECODER} {PIL.__version__}"


def open_rgb(path: str):
    """A frame as an RGB ``PIL.Image``."""
    with pil_image().open(path) as im:
        return im.convert("RGB")


def open_mask(path: str):
    """A mask in its stored mode (``L`` or ``P``: class indices)."""
    with pil_image().open(path) as im:
        im.load()
        return im


def open_binary_mask(path: str):
    """A mask as a 1-bit ``PIL.Image``: PIL's own ``convert("1")``, which
    thresholds an 8-bit source with Floyd-Steinberg dither (the reference's
    S4 and MS3 loaders)."""
    with pil_image().open(path) as im:
        return im.convert("1")


def write_jpeg(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] -> JPEG at PIL's default quality."""
    pil_image().fromarray(rgb).save(path)


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 [H, W, 3] or [H, W] -> PNG (RGB or 8-bit grayscale)."""
    pil_image().fromarray(image).save(path)


def write_index_png(path: str, mask: np.ndarray) -> None:
    """uint8 [H, W] class indices -> 8-bit grayscale (``L``) PNG."""
    if mask.dtype != np.uint8 or mask.ndim != 2:
        raise ValueError(f"an index mask is uint8 [H, W], not {mask.dtype} {mask.shape}")
    pil_image().fromarray(mask).save(path)
