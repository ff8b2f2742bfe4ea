"""PPM (P3) readback + golden comparison — counterpart of
``rt/render/ppm.py``.

Writer: header ``P3\\n{w} {h} 255\\n``, all pixels on ONE line as
``"{r} {g} {b} "``; channel = raw LINEAR value * 255 with Rust ``as u8``
semantics (truncate toward zero, saturate to [0, 255], NaN -> 0).
Comparator: dimension lines must match; mean absolute per-channel u8
difference as a percentage of 255 must be <= tolerance.
"""

from __future__ import annotations

import numpy as np

from rt_torch.scene import native_bridge


def image_to_u8(image: np.ndarray) -> np.ndarray:
    v = np.asarray(image, np.float32) * 255.0
    v = np.nan_to_num(v, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(np.trunc(v), 0.0, 255.0).astype(np.uint8)


def render_ppm(image: np.ndarray, use_native: bool = True) -> str:
    """The P3 text; through the C++ writer (``scene.native_bridge``) where
    it builds, byte for byte the Python one below."""
    if use_native and native_bridge.available():
        return native_bridge.render_ppm(np.asarray(image, np.float32))
    h, w = image.shape[:2]
    body = "".join(f"{r} {g} {b} " for r, g, b in
                   image_to_u8(image).reshape(-1, 3))
    return f"P3\n{w} {h} 255\n{body}"


def write_ppm(path: str, image: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(render_ppm(image))


def parse_ppm(text: str):
    """dims from line 1, pixels from lines[2:], any u8-parseable token."""
    lines = text.splitlines()
    if len(lines) < 2:
        raise ValueError("not a P3 file")
    vals = []
    for t in " ".join(lines[2:]).split():
        try:
            v = int(t)
        except ValueError:
            continue
        if 0 <= v <= 255:
            vals.append(v)
    return lines[1], np.array(vals, np.uint8)


def compare_ppm(img1: str, img2: str, tolerance_percent: float = 2.0):
    """Returns (ok, avg_diff_percent).  Raises ValueError on a mismatch of
    dimensions or pixel count."""
    d1, p1 = parse_ppm(img1)
    d2, p2 = parse_ppm(img2)
    if d1 != d2:
        raise ValueError(f"different dimensions: {d1!r} vs {d2!r}")
    if len(p1) != len(p2):
        raise ValueError(f"pixel count mismatch: {len(p1)} vs {len(p2)}")
    diff = np.abs(p1.astype(np.float32) - p2.astype(np.float32)).sum()
    pct = diff / len(p1) / 255.0 * 100.0
    return pct <= tolerance_percent, float(pct)
