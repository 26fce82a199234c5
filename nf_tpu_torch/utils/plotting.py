"""Report panels drawn with numpy alone (counterpart of
``nf_tpu/utils/plotting.py``, which draws with matplotlib and saves with
PIL; the card's machine has neither).

One code path, the same on every machine:

* ``scatter_plot``: a 600 x 600 x 3 uint8 canvas (nf_tpu's
  ``figsize=(6, 6)`` at 100 dpi), white, with a frame round the axes box;
  2-D points of 2 x 2 px over nf_tpu's limits of +-1.1, 3-D points
  through a fixed orthographic view (elevation 30 degrees, azimuth -60,
  matplotlib's default) over each axis's data range, drawn far to near;
  ``colors`` through the port's 256-entry viridis table, scaled to their
  range as matplotlib scales them, else matplotlib's first colour;
* ``image_plot``: the heatmap scaled to the axes box (row 0 at the top,
  as ``imshow`` draws it), viridis over its range, and a colour strip at
  the right;
* no titles: the step is in the TensorBoard tag and the file name;
* ``make_grid``: nf_tpu's, value for value;
* ``save_image``: nf_tpu's conversion to uint8, then baseline JPEG at
  nf_tpu's quality 90 (``utils/jpeg.py``);
* ``assemble_gif`` keeps nf_tpu's lazy PIL import (only
  ``scripts/reproduce_golden.py`` calls it).
"""
from __future__ import annotations

import numpy as np

from . import jpeg

SIZE = 600                      # pixels a side (6 in at 100 dpi)
BOX = (72, 528, 66, 534)        # the axes box: top, bottom, left, right
STRIP = (548, 566)              # image_plot's colour strip: left, right
LIMIT = 1.1                     # nf_tpu's 2-D axis limits
DEFAULT_COLOR = (31, 119, 180)  # matplotlib's first colour, C0
ELEVATION, AZIMUTH = 30.0, -60.0

# viridis, 256 entries of RGB
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"), np.uint8).reshape(256, 3)


def colormap(values) -> np.ndarray:
    """(N, 3) uint8 viridis colours of ``values`` over their range."""
    v = np.asarray(values, np.float64)
    finite = v[np.isfinite(v)]
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 0.0)
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = (np.clip(np.nan_to_num(t), 0.0, 1.0) * 255.0 + 0.5).astype(np.int64)
    return VIRIDIS[idx]


def _canvas() -> np.ndarray:
    img = np.full((SIZE, SIZE, 3), 255, np.uint8)
    top, bottom, left, right = BOX
    img[top - 1, left - 1:right + 1] = 0
    img[bottom, left - 1:right + 1] = 0
    img[top - 1:bottom + 1, left - 1] = 0
    img[top - 1:bottom + 1, right] = 0
    return img


def _dots(img, u, v, colors) -> None:
    """2 x 2 px dots at the box fractions (u right, v up) in [0, 1], in
    order (later over earlier); points outside the box are dropped."""
    top, bottom, left, right = BOX
    ok = np.isfinite(u) & np.isfinite(v) & (u > -1.0) & (u < 2.0) & (v > -1.0) & (v < 2.0)
    u, v, colors = u[ok], v[ok], colors[ok]
    col = np.floor(left + u * (right - left)).astype(np.int64)
    row = np.floor(bottom - v * (bottom - top)).astype(np.int64)
    for dr in (-1, 0):
        for dc in (0, 1):
            r, c = row + dr, col + dc
            keep = (r >= top) & (r < bottom) & (c >= left) & (c < right)
            img[r[keep], c[keep]] = colors[keep]


def _view(xs, ys, zs):
    """Screen (u, v, depth) of 3-D points in the fixed orthographic view,
    each axis scaled to [-1, 1] over its data range."""
    pts = []
    for a in (xs, ys, zs):
        a = np.asarray(a, np.float64)
        finite = a[np.isfinite(a)]
        lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 0.0)
        pts.append((a - lo) / (hi - lo) * 2.0 - 1.0 if hi > lo else np.zeros_like(a))
    x, y, z = pts
    e, a = np.radians(ELEVATION), np.radians(AZIMUTH)
    with np.errstate(invalid="ignore"):    # a non-finite point is dropped by _dots
        right = -np.sin(a) * x + np.cos(a) * y
        up = -np.sin(e) * np.cos(a) * x - np.sin(e) * np.sin(a) * y + np.cos(e) * z
        depth = np.cos(e) * np.cos(a) * x + np.cos(e) * np.sin(a) * y + np.sin(e) * z
    reach = np.sqrt(3.0)   # the cube's half-diagonal: every view fits
    return (right / reach + 1.0) / 2.0, (up / reach + 1.0) / 2.0, depth


def scatter_plot(xs, ys, zs=None, colors=None, title="") -> np.ndarray:
    """(600, 600, 3) uint8 scatter of the points (``title`` is not drawn)."""
    xs = np.asarray(xs, np.float64)
    n = xs.shape[0]
    rgb = (np.tile(np.array(DEFAULT_COLOR, np.uint8), (n, 1)) if colors is None
           else colormap(colors))
    img = _canvas()
    if zs is None:
        u = (xs + LIMIT) / (2 * LIMIT)
        v = (np.asarray(ys, np.float64) + LIMIT) / (2 * LIMIT)
        _dots(img, u, v, rgb)
    else:
        u, v, depth = _view(xs, ys, zs)
        order = np.argsort(-depth, kind="stable")   # the far ones first
        _dots(img, u[order], v[order], rgb[order])
    return img


def _resize_nearest(values: np.ndarray, h: int, w: int) -> np.ndarray:
    rows = (np.arange(h) * values.shape[0]) // h
    cols = (np.arange(w) * values.shape[1]) // w
    return values[rows][:, cols]


def image_plot(values: np.ndarray, title="", extent=(-1, 1, -1, 1)) -> np.ndarray:
    """(600, 600, 3) uint8 heatmap of ``values`` (row 0 at the top), with a
    colour strip (``title`` and ``extent`` label nothing here)."""
    values = np.asarray(values, np.float64)
    img = _canvas()
    top, bottom, left, right = BOX
    h, w = bottom - top, right - left
    cells = _resize_nearest(values, h, w)
    img[top:bottom, left:right] = colormap(cells.ravel()).reshape(h, w, 3)
    s0, s1 = STRIP
    ramp = VIRIDIS[np.linspace(255, 0, h).round().astype(np.int64)]
    img[top:bottom, s0:s1] = ramp[:, None, :]
    return img


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 1,
              pad_value: float = 1.0) -> np.ndarray:
    """(N, H, W, C) float [0,1] -> single (H', W', C) grid array."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def assemble_gif(frame_paths, out_path: str, duration_ms: int = 200) -> bool:
    """Training-progress movie from saved report frames (needs PIL, as
    nf_tpu's)."""
    from PIL import Image

    frames = [Image.open(p).convert("P") for p in frame_paths]
    if not frames:
        return False
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return True


def to_uint8(array) -> np.ndarray:
    """nf_tpu's ``save_image`` conversion: a float array in [0, 1.5] scaled
    by 255, clipped to [0, 255]; a trailing channel of 1 dropped."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def save_image(path: str, array: np.ndarray) -> None:
    """``array`` as a baseline JPEG at quality 90."""
    data = jpeg.encode(to_uint8(array), quality=90)
    with open(path, "wb") as f:
        f.write(data)
