"""numpy counterparts of the five OpenCV calls the JAX package draws with,
so that the port's viz and `compat.raster_collision` run where cv2 does
not import.

- `fill_convex_poly(img, pts, color)`: `cv2.fillConvexPoly` for int32
  vertices, shift 0, LINE_8, bit-equal. It reproduces OpenCV's algorithm,
  not a point-in-polygon test: the outline is drawn first as 8-connected
  Bresenham lines clipped to the image (`LineIterator`, left to right),
  then the rows between the top and the bottom vertex are filled with the
  spans of a two-edge walk in 16-bit fixed point. Each edge starts at its
  upper vertex's x and steps by a slope rounded by C's truncating
  division, so the spans' ends differ from the exact edges' by up to a
  pixel, and the outline may stick out of a span. `polygon_pixels` gives
  the same pixels as flat indices without an image.
- `line(img, p0, p1, color, thickness=1)`: `cv2.line(..., LINE_AA)`, not
  bit-equal. The line is clipped to the image in 16-bit fixed point as
  OpenCV clips it; each step along the major axis, from the first end to
  one pixel past the last, blends three pixels across the line
  (round(c) - 1 .. round(c) + 1, c the exact minor coordinate) with a
  Gaussian weight of their offset from c, scaled up with the slope and
  down at the ends, fitted to OpenCV's three-tap filter. Held to cv2
  (tests/test_torch_viz.py), on a background of one random colour: where
  both change pixels, the two sets of changed pixels are within 1 pixel
  of each other (symmetric Hausdorff distance); where cv2 changes none (a
  line of zero length, or clipped to one point), the port changes at most
  2; the mean absolute difference over the pixels either changes is at
  most 24 levels for a line, and at most 4 averaged over the lines.
- `apply_jet(gray)`: `cv2.applyColorMap(gray, COLORMAP_JET)`, bit-equal
  (the table below is cv2's).
- `resize_linear(img, factor)`: `cv2.resize(img, (w * f, h * f))` with the
  default INTER_LINEAR on uint8 at an integer factor, bit-equal: 11-bit
  weights, the horizontal pass in int32, the vertical pass as OpenCV's
  SIMD path computes it (each row's sum shifted right by 4, a 16-bit
  high multiply by each weight, a rounding shift by 2), the weights of
  the first and last rows left unclamped as OpenCV leaves them.
- `bgr_to_rgb(img)`: `cv2.cvtColor(img, COLOR_BGR2RGB)` (and back).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
#                   cv2.COLORMAP_JET).reshape(-1).tobytes().hex()
# (OpenCV 5.0.0): 256 BGR triples.
_JET_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080")
JET_BGR = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, p1, p2):
    """OpenCV's `clipLine` on integer points -> (visible, p1, p2). The
    second endpoint's x update reads the first's already clipped x, as
    OpenCV's does."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8_pixels(p1, p2, height: int, width: int):
    """(ys, xs) of OpenCV's 8-connected line p1 -> p2 (`LineIterator`,
    left to right) clipped to a height x width image."""
    visible, (x1, y1), (x2, y2) = _clip_line(width, height, p1, p2)
    if not visible:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    k = np.arange(max(dx, dy) + 1, dtype=np.int64)
    if dy > dx:                  # y is the major axis
        minor = -((dy - 2 * dx * k) // (2 * dy))
        return y1 + sy * k, x1 + minor
    minor = (-((dx - 2 * dy * k) // (2 * dx)) if dx
             else np.zeros_like(k))
    return y1 + sy * minor, x1 + k


def _fill_spans(v: list, height: int, width: int) -> list:
    """The (y, x_left, x_right) spans of OpenCV's FillConvexPoly edge walk
    (shift 0, LINE_8), clipped to the image; the outline is not in them."""
    npts = len(v)
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    ymin, ymax = min(ys), max(ys)
    imin = ys.index(ymin)
    if (npts < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= width
            or ymin >= height):
        return []
    ymax = min(ymax, height - 1)
    half = XY_ONE >> 1
    edges = npts
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    spans = []
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    if edges <= 0:
                        edges -= 1
                        break
                    edges -= 1
                    ty = ys[idx]
                    if ty > y:
                        xs0 = xs[idx0] << XY_SHIFT
                        xe = xs[idx] << XY_SHIFT
                        e[4] = ty
                        e[3] = _cdiv((xe - xs0) * 2 + (ty - y),
                                     2 * (ty - y))
                        e[2] = xs0
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] \
                else (edge[0], edge[1])
            xx1 = (left[2] + half) >> XY_SHIFT
            xx2 = (right[2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < width:
                xx1, xx2 = max(xx1, 0), min(xx2, width - 1)
                if xx1 <= xx2:
                    spans.append((y, xx1, xx2))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    return spans


def _vertices(pts) -> list:
    v = np.asarray(pts)
    if v.dtype.kind not in "iu":
        raise TypeError(f"vertices must be integers (cv2's int32 points), "
                        f"got {v.dtype}")
    return [(int(x), int(y)) for x, y in v.reshape(-1, 2)]


def polygon_pixels(pts, height: int, width: int) -> np.ndarray:
    """Sorted unique flat indices (y * width + x) of the pixels that
    `fill_convex_poly` sets in a height x width image."""
    v = _vertices(pts)
    if not v:
        return np.zeros(0, np.int64)
    parts = []
    p0 = v[-1]
    for p in v:
        ys, xs = _line8_pixels(p0, p, height, width)
        parts.append(ys * width + xs)
        p0 = p
    for y, x1, x2 in _fill_spans(v, height, width):
        parts.append(np.arange(y * width + x1, y * width + x2 + 1))
    return np.unique(np.concatenate(parts))


def fill_convex_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """`cv2.fillConvexPoly(img, pts, color)` for int vertices (shift 0,
    LINE_8): fills `img` (H, W) or (H, W, C) in place and returns it."""
    h, w = img.shape[:2]
    flat = polygon_pixels(pts, h, w)
    view = img.reshape(h * w, *img.shape[2:])
    color = np.asarray(color, np.float64).reshape(-1)
    view[flat] = color[:img.shape[2]] if img.ndim == 3 else color[0]
    return img


def _blend(img, ys, xs, color, alpha):
    """img[y, x] += (color - img[y, x]) * alpha / 256, rounded as OpenCV's
    ICV_PUT_POINT rounds."""
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    ys, xs, alpha = ys[keep], xs[keep], alpha[keep]
    if not len(ys):
        return
    cur = img[ys, xs].astype(np.int32)
    a = alpha.astype(np.int32).reshape(-1, *([1] * (cur.ndim - 1)))
    img[ys, xs] = np.clip(cur + (((color - cur) * a + 127) >> 8), 0, 255)


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, thickness, cv2.LINE_AA)` on a uint8
    (H, W, 3) image, in place, within the module docstring's tolerance.
    Only thickness 1 (the JAX viz's default) is drawn."""
    if thickness != 1:
        raise ValueError(f"raster.line draws thickness 1 only, got "
                         f"{thickness}")
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError("raster.line draws on a uint8 (H, W, C) image")
    h, w = img.shape[:2]
    # clipped to the image in 16-bit fixed point, as OpenCV's LineAA clips
    visible, q0, q1 = _clip_line(
        w << XY_SHIFT, h << XY_SHIFT,
        (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT),
        (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT))
    if not visible:
        return img
    x0, y0, x1, y1 = (c / XY_ONE for c in (*q0, *q1))
    color = np.asarray(color, np.int32).reshape(-1)[:img.shape[2]]
    dx, dy = x1 - x0, y1 - y0
    steep = abs(dy) > abs(dx)
    if steep:                           # walk along y
        x0, y0, x1, y1, dx, dy = y0, x0, y1, x1, dy, dx
    if dx < 0:
        x0, y0, x1, y1, dx, dy = x1, y1, x0, y0, -dx, -dy
    slope = dy / dx if dx else 0.0
    start, end = int(np.floor(x0 + 0.5)), int(np.floor(x1 + 0.5))
    # the walk runs one pixel past the end; the end pixels get part of the
    # ink and the one past it a trace, as OpenCV's end-point table gives
    major = np.arange(start, end + 2, dtype=np.int64)
    ends = np.ones(len(major))
    ends[0], ends[-2], ends[-1] = _AA_FIRST, _AA_LAST, _AA_TRACE
    if start == end:
        ends[:] = _AA_TRACE
    centre = y0 + slope * (major - x0)
    base = np.floor(centre + 0.5).astype(np.int64)
    ink = _AA_PEAK * np.sqrt(1.0 + slope * slope) * ends
    for off in (-1, 0, 1):
        minor = base + off
        dist = minor - centre           # across the walk, in pixels
        alpha = np.minimum(255.0, ink * np.exp(-dist * dist / _AA_TWO_VAR))
        ys, xs = (major, minor) if steep else (minor, major)
        _blend(img, ys, xs, color, alpha.astype(np.int32))
    return img


# the three-tap filter of `line`, fitted to OpenCV's: a horizontal line's
# centre row takes 232 of 256 and its neighbours 55, a diagonal's 255 and
# 79; the first pixel 0.62 and the last 0.65 of that, the one past it 0.01
_AA_PEAK = 232.0
_AA_TWO_VAR = 2 * 0.35
_AA_FIRST, _AA_LAST, _AA_TRACE = 0.62, 0.65, 0.01


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """`cv2.applyColorMap(gray, cv2.COLORMAP_JET)`: uint8 (H, W) ->
    (H, W, 3) BGR."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise ValueError(f"apply_jet takes uint8, got {gray.dtype}")
    return JET_BGR[gray]


def _linear_taps(n: int, factor: int, clamp_weights: bool):
    """Source indices (i0, i1) and 11-bit weights (w0, w1) of OpenCV's
    INTER_LINEAR for an upscale of n samples by `factor`."""
    d = np.arange(n * factor)
    f = ((d + 0.5) * (1.0 / factor) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:                   # OpenCV clamps x's weights only
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= n - 1] = 0
        s[s >= n - 1] = n - 1
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, n - 1), np.clip(s + 1, 0, n - 1), w0, w1


def resize_linear(img: np.ndarray, factor: int) -> np.ndarray:
    """`cv2.resize(img, (w * factor, h * factor))` (INTER_LINEAR) on a
    uint8 (H, W) or (H, W, C) image, bit-equal."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, got {img.dtype}")
    if int(factor) != factor or factor < 1:
        raise ValueError(f"resize_linear takes an integer factor >= 1, got "
                         f"{factor}")
    factor = int(factor)
    h, w = img.shape[:2]
    a = img.astype(np.int64).reshape(h, w, -1)
    x0, x1, ax0, ax1 = _linear_taps(w, factor, True)
    y0, y1, ay0, ay1 = _linear_taps(h, factor, False)
    rows = a[:, x0] * ax0[None, :, None] + a[:, x1] * ax1[None, :, None]
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((s0 * ay0[:, None, None]) >> 16)
           + ((s1 * ay1[:, None, None]) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape(h * factor, w * factor, *img.shape[2:])


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_BGR2RGB)`: the channels reversed (a
    contiguous copy); the same call converts RGB to BGR."""
    return np.ascontiguousarray(img[..., ::-1])
