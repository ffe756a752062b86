"""Image I/O: PNG / PPM read-write.

Host-side numpy code, the same functions as the JAX package's
``utils/image_io.py``. Rendered frames are tensors; only the final uint8
frame crosses to the host.

PNG encoding prefers the in-tree native C++ codec (repo-root ``native/``)
and falls back to PIL when the shared library has not been built.

Orientation: the renderer's row 0 is the image *bottom* (+v is world up,
ops/camera.py). ``to_uint8_image`` flips vertically so saved files read
top-down; ``parity_flip=True`` reproduces the reference's 180° savePNG
rotation (image.cu:84-98).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def to_uint8_image(rgba: np.ndarray, *, parity_flip: bool = False) -> np.ndarray:
    """[H, W, 4] float rgba in [0,1] (row 0 = bottom) -> uint8 top-down image.

    Saturation matches rgbaFloatToInt (volumeRender_kernel.cu:266-274):
    clamp to [0,1] then truncate at 255 scale.
    """
    rgba = np.asarray(rgba)
    img = np.clip(rgba, 0.0, 1.0)
    img = (img * 255.0).astype(np.uint8)
    if parity_flip:
        img = img[::-1, ::-1]
    else:
        img = img[::-1]
    return img


def _native_codec():
    try:
        from ..native import codec  # lazy: needs the built shared library

        return codec if codec.available() else None
    except Exception:
        return None


def save_png(path: str, rgba_u8: np.ndarray, *, use_native: Optional[bool] = None) -> None:
    """Write an RGBA (or RGB/grayscale) uint8 array as PNG."""
    rgba_u8 = np.ascontiguousarray(rgba_u8)
    codec = _native_codec() if use_native in (None, True) else None
    if codec is not None:
        codec.encode_png(path, rgba_u8)
        return
    if use_native:
        raise RuntimeError("native PNG codec requested but not built (see native/Makefile)")
    from PIL import Image

    Image.fromarray(rgba_u8).save(path)


def load_png(path: str, *, use_native: Optional[bool] = None) -> np.ndarray:
    """Read a PNG as [H, W, 4] uint8 (RGBA; row 0 = top)."""
    codec = _native_codec() if use_native in (None, True) else None
    if codec is not None:
        arr = codec.decode_png(path)
    else:
        if use_native:
            raise RuntimeError("native PNG codec requested but not built")
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("RGBA"))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    if arr.shape[-1] == 3:
        alpha = np.full(arr.shape[:-1] + (1,), 255, np.uint8)
        arr = np.concatenate([arr, alpha], axis=-1)
    return arr


def load_matcap(path: str) -> np.ndarray:
    """Load a matcap texture as [H, W, 4] float32 in [0,1] for shading."""
    return load_png(path).astype(np.float32) / 255.0


def save_ppm(path: str, rgb_u8: np.ndarray) -> None:
    """Write binary P6 PPM (the reference's golden-image format)."""
    rgb = np.ascontiguousarray(rgb_u8[..., :3])
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w}\n{h}\n255\n".encode())
        f.write(rgb.tobytes())


def load_ppm(path: str) -> np.ndarray:
    """Read binary P6 PPM as [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    fields = []
    pos = 0
    while len(fields) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"unsupported PPM: magic={magic!r} maxval={maxval}")
    pixels = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    return pixels.reshape(h, w, 3).copy()
