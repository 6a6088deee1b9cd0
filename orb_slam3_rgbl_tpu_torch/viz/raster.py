"""A small numpy rasterizer for the viewer: an RGB ``Canvas`` with disks,
squares, rings, crosses, lines (a DDA walk, one sample per pixel step, as
Bresenham's), a built-in 5×7 bitmap font, and the two views' projections —
an auto-fitted top-down one and a fixed oblique one. Written as PNG through
``io/png.write_png``."""

from __future__ import annotations

import numpy as np

from orb_slam3_rgbl_tpu_torch.io.png import write_png

GREEN = (0, 255, 0)
RED = (255, 0, 0)
BLUE = (31, 119, 180)
GRAY = (153, 153, 153)
BLACK = (0, 0, 0)
WHITE = (255, 255, 255)
OLIVE = (188, 189, 34)
DARK_GREEN = (44, 160, 44)

GLYPH_W, GLYPH_H = 5, 7
_FONT_ROWS = {
    "A": ".###.|#...#|#...#|#####|#...#|#...#|#...#",
    "B": "####.|#...#|#...#|####.|#...#|#...#|####.",
    "C": ".###.|#...#|#....|#....|#....|#...#|.###.",
    "D": "####.|#...#|#...#|#...#|#...#|#...#|####.",
    "E": "#####|#....|#....|####.|#....|#....|#####",
    "F": "#####|#....|#....|####.|#....|#....|#....",
    "G": ".###.|#...#|#....|#.###|#...#|#...#|.###.",
    "H": "#...#|#...#|#...#|#####|#...#|#...#|#...#",
    "I": ".###.|..#..|..#..|..#..|..#..|..#..|.###.",
    "J": "..###|...#.|...#.|...#.|...#.|#..#.|.##..",
    "K": "#...#|#..#.|#.#..|##...|#.#..|#..#.|#...#",
    "L": "#....|#....|#....|#....|#....|#....|#####",
    "M": "#...#|##.##|#.#.#|#.#.#|#...#|#...#|#...#",
    "N": "#...#|#...#|##..#|#.#.#|#..##|#...#|#...#",
    "O": ".###.|#...#|#...#|#...#|#...#|#...#|.###.",
    "P": "####.|#...#|#...#|####.|#....|#....|#....",
    "Q": ".###.|#...#|#...#|#...#|#.#.#|#..#.|.##.#",
    "R": "####.|#...#|#...#|####.|#.#..|#..#.|#...#",
    "S": ".####|#....|#....|.###.|....#|....#|####.",
    "T": "#####|..#..|..#..|..#..|..#..|..#..|..#..",
    "U": "#...#|#...#|#...#|#...#|#...#|#...#|.###.",
    "V": "#...#|#...#|#...#|#...#|#...#|.#.#.|..#..",
    "W": "#...#|#...#|#...#|#.#.#|#.#.#|#.#.#|.#.#.",
    "X": "#...#|#...#|.#.#.|..#..|.#.#.|#...#|#...#",
    "Y": "#...#|#...#|.#.#.|..#..|..#..|..#..|..#..",
    "Z": "#####|....#|...#.|..#..|.#...|#....|#####",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": "#####|...#.|..#..|...#.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": "..##.|.#...|#....|####.|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|.#...|.#...|.#...",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|...#.|.##..",
    "a": ".....|.....|.###.|....#|.####|#...#|.####",
    "c": ".....|.....|.###.|#....|#....|#...#|.###.",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.",
    "h": "#....|#....|#.##.|##..#|#...#|#...#|#...#",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#...#|#...#",
    "s": ".....|.....|.####|#....|.###.|....#|####.",
    "t": ".#...|.#...|###..|.#...|.#...|.#..#|..##.",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    "y": ".....|.....|#...#|#...#|.####|....#|.###.",
    "z": ".....|.....|#####|...#.|..#..|.#...|#####",
    ":": ".....|.##..|.##..|.....|.##..|.##..|.....",
    "|": "..#..|..#..|..#..|..#..|..#..|..#..|..#..",
    "_": ".....|.....|.....|.....|.....|.....|#####",
    "[": ".###.|.#...|.#...|.#...|.#...|.#...|.###.",
    "]": ".###.|...#.|...#.|...#.|...#.|...#.|.###.",
    "-": ".....|.....|.....|#####|.....|.....|.....",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    " ": ".....|.....|.....|.....|.....|.....|.....",
}
FONT = {c: np.array([[ch == "#" for ch in row] for row in rows.split("|")])
        for c, rows in _FONT_ROWS.items()}
# a character the font lacks: an outlined box
UNKNOWN_GLYPH = np.array([[True] * 5] + [[True, False, False, False, True]] * 5 + [[True] * 5])


def _offsets(shape: str, radius: int) -> np.ndarray:
    """(n, 2) integer (dx, dy) offsets of a marker around its centre."""
    r = np.arange(-radius, radius + 1)
    dx, dy = np.meshgrid(r, r)
    d2 = dx * dx + dy * dy
    keep = {"square": np.ones_like(d2, bool), "disk": d2 <= radius * radius + radius,
            "ring": (d2 <= radius * radius + radius) & (d2 > (radius - 1) ** 2 + radius - 1)}[shape]
    return np.stack([dx[keep], dy[keep]], 1)


class Canvas:
    """An (h, w, 3) uint8 image; coordinates are (x = column, y = row)
    floats, rounded to the nearest pixel; whatever falls outside is
    dropped."""

    def __init__(self, h: int, w: int, bg=WHITE):
        self.img = np.empty((h, w, 3), np.uint8)
        self.img[:] = bg

    @property
    def shape(self):
        return self.img.shape[:2]

    def put(self, xy: np.ndarray, color):
        """Set the pixels at (n, 2) coordinates ``xy``."""
        xy = np.round(np.asarray(xy, np.float64).reshape(-1, 2))
        h, w = self.shape
        ok = np.isfinite(xy).all(1)
        xy = xy[ok].astype(np.int64)
        ok = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        self.img[xy[ok, 1], xy[ok, 0]] = color

    def markers(self, xy, color, radius: int = 0, shape: str = "disk"):
        """A marker (``disk``, ``square`` or ``ring``) at each point."""
        xy = np.round(np.asarray(xy, np.float64).reshape(-1, 2))
        off = _offsets(shape, radius) if radius > 0 else np.zeros((1, 2))
        self.put((xy[:, None, :] + off[None]).reshape(-1, 2), color)

    def crosses(self, xy, color, size: int = 3):
        """A '+' of arm ``size`` at each point."""
        r = np.arange(-size, size + 1)
        z = np.zeros_like(r)
        off = np.concatenate([np.stack([r, z], 1), np.stack([z, r], 1)])
        xy = np.round(np.asarray(xy, np.float64).reshape(-1, 2))
        self.put((xy[:, None, :] + off[None]).reshape(-1, 2), color)

    def lines(self, a, b, color):
        """Segments from each point of ``a`` (n, 2) to ``b``'s: one sample
        per step along the longer axis."""
        a = np.asarray(a, np.float64).reshape(-1, 2)
        b = np.asarray(b, np.float64).reshape(-1, 2)
        ok = np.isfinite(a).all(1) & np.isfinite(b).all(1)
        a, b = a[ok], b[ok]
        if not len(a):
            return
        h, w = self.shape
        d = b - a
        # a segment far longer than the canvas is sampled at most 2(h + w) times
        n = np.minimum(np.ceil(np.abs(d).max(1)), 2 * (h + w)).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(a)), n)
        start = np.repeat(np.cumsum(n) - n, n)
        t = (np.arange(seg.size) - start) / np.maximum(n - 1, 1)[seg]
        self.put(a[seg] + t[:, None] * d[seg], color)

    def polyline(self, xy, color):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        if len(xy) > 1:
            self.lines(xy[:-1], xy[1:], color)

    def text(self, x: int, y: int, s: str, color, scale: int = 1) -> int:
        """``s`` in the 5×7 font, its top-left corner at (x, y), each
        glyph cell (5 + 1) × ``scale`` wide; returns the x after it."""
        for ch in s:
            g = FONT.get(ch, UNKNOWN_GLYPH)
            rows, cols = np.nonzero(np.kron(g, np.ones((scale, scale), bool)))
            self.put(np.stack([x + cols, y + rows], 1), color)
            x += (GLYPH_W + 1) * scale
        return x

    def save(self, path: str) -> str:
        write_png(path, self.img)
        return path


def text_width(s: str, scale: int = 1) -> int:
    return len(s) * (GLYPH_W + 1) * scale


def fit_view(points, size, margin: int = 40):
    """A map (n, 2) world → (n, 2) pixel coordinates that fits every
    non-empty array of ``points`` into a ``size`` = (w, h) image with equal
    scale on both axes and the world's second axis pointing up."""
    pts = [np.asarray(p, np.float64).reshape(-1, 2) for p in points if p is not None and len(p)]
    pts = np.concatenate(pts) if pts else np.zeros((0, 2))
    pts = pts[np.isfinite(pts).all(1)]
    w, h = size
    if len(pts):
        lo, hi = pts.min(0), pts.max(0)
    else:
        lo, hi = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    span = np.maximum(hi - lo, 1e-6)
    s = min((w - 2 * margin) / span[0], (h - 2 * margin) / span[1])
    mid = 0.5 * (lo + hi)

    def to_px(xy):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        return np.stack([w / 2 + s * (xy[:, 0] - mid[0]), h / 2 - s * (xy[:, 1] - mid[1])], 1)

    return to_px


def oblique(azim_deg: float = -60.0, elev_deg: float = 30.0):
    """An orthographic projection (n, 3) → (n, 2) of plot coordinates seen
    from azimuth ``azim_deg`` and elevation ``elev_deg`` (matplotlib's
    default 3-D view): screen right and screen up."""
    a, e = np.radians(azim_deg), np.radians(elev_deg)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])

    def project(p):
        p = np.asarray(p, np.float64).reshape(-1, 3)
        return np.stack([p @ right, p @ up], 1)

    return project
