"""Headless renders, plots and animations (port of autourdf_tpu.viz), drawn
by a small numpy rasteriser and written as PNG and GIF by hand.

The JAX module draws with matplotlib and writes GIFs with PIL; neither is
on the machine with the card, so the same eleven functions, with the same
signatures, draw here on a :class:`Canvas`:

- 3-D views are orthographic, from matplotlib's default camera (elevation
  30 degrees, azimuth -60 degrees), inside the cube that the JAX module's
  ``_equal_aspect`` sets; points are z-buffered square splats, triangles are
  z-buffered and flat-shaded, line segments (joint axes, tree edges) are
  drawn over them in call order;
- the 2-D plots are polylines and a colour-mapped grid inside a framed box
  with a light grid;
- colours are matplotlib's (``C0`` blue, gray, red, the jet ramp of
  ``urdf/writer.py``, the Blues ramp).

No text is drawn: titles, tick labels and joint names are left out
(``title`` is accepted and ignored).  PNGs are 8-bit RGB through ``zlib``;
GIFs are GIF89a with one global 256-colour palette, LZW-coded, looping, each
frame shown ``1000 / fps`` ms as in the JAX module.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .urdf.writer import jet

ELEV_DEG, AZIM_DEG = 30.0, -60.0
C0 = (31, 119, 180)       # matplotlib's first cycle colour
GRAY = (128, 128, 128)
LIGHTGRAY = (211, 211, 211)
GRIDGRAY = (176, 176, 176)
RED = (255, 0, 0)
BLACK = (0, 0, 0)
# matplotlib's "Blues": the nine knots it interpolates linearly
_BLUES = np.array([[247, 251, 255], [222, 235, 247], [198, 219, 239], [158, 202, 225],
                   [107, 174, 214], [66, 146, 198], [33, 113, 181], [8, 81, 156],
                   [8, 48, 107]], np.float64)
PIXELS_PER_INCH = 100


# ---------------------------------------------------------------------------
# Colours

def jet_colors(values: np.ndarray) -> np.ndarray:
    """(N,) floats in [0, 1] -> (N, 3) uint8 of matplotlib's jet."""
    values = np.asarray(values, np.float64)
    uniq, inv = np.unique(values, return_inverse=True)
    table = np.array([[round(255 * c) for c in jet(float(u))[:3]] for u in uniq], np.uint8)
    return table[inv.reshape(-1)].reshape(values.shape + (3,))


def blues_colors(values: np.ndarray) -> np.ndarray:
    """Floats in [0, 1] -> uint8 RGB of matplotlib's Blues."""
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    knots = np.linspace(0.0, 1.0, len(_BLUES))
    rgb = np.stack([np.interp(v, knots, _BLUES[:, c]) for c in range(3)], axis=-1)
    return np.round(rgb).astype(np.uint8)


def _color_array(colors, n: int, default=C0) -> np.ndarray:
    """matplotlib-style colours (None, one RGB(A) in [0, 1] or 0..255, or
    one per point) -> (n, 3) uint8."""
    if colors is None:
        return np.tile(np.array(default, np.uint8), (n, 1))
    c = np.asarray(colors)
    if c.dtype.kind == "f":
        c = np.round(np.clip(c, 0.0, 1.0) * 255)
    c = c.astype(np.uint8)[..., :3]
    return np.tile(c, (n, 1)) if c.ndim == 1 else c


# ---------------------------------------------------------------------------
# The camera

def view_basis():
    """Screen right, screen up and toward-the-eye unit vectors of
    matplotlib's default 3-D camera."""
    e, a = np.radians(ELEV_DEG), np.radians(AZIM_DEG)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])
    eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    return right, up, eye


def cube_limits(pts: np.ndarray) -> tuple[np.ndarray, float]:
    """Centre and half-width of the JAX module's ``_equal_aspect`` cube."""
    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    lo, hi = pts.min(0), pts.max(0)
    return (lo + hi) / 2, max(float((hi - lo).max()) / 2, 1e-6)


class View:
    """Orthographic projection of the cube ``centre +- half`` onto a
    ``size x size`` image: the cube's circumscribed sphere fills it."""

    def __init__(self, centre, half: float, size: int):
        self.centre, self.half, self.size = np.asarray(centre, np.float64), float(half), size
        self.right, self.up, self.eye = view_basis()

    def project(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, 3) world points -> continuous column, row (pixel centres at
        integers) and depth (larger is nearer the eye)."""
        q = (np.asarray(pts, np.float64).reshape(-1, 3) - self.centre) / self.half
        s = (self.size - 1) / 2
        r3 = np.sqrt(3.0)
        col = s * (1.0 + q @ self.right / r3)
        row = s * (1.0 - q @ self.up / r3)
        return col, row, q @ self.eye


# ---------------------------------------------------------------------------
# The canvas

class Canvas:
    """An RGB image with a depth buffer for z-tested fragments."""

    def __init__(self, width: int, height: int):
        self.rgb = np.full((height, width, 3), 255, np.uint8)
        self.depth = np.full((height, width), -np.inf)

    @property
    def shape(self):
        return self.rgb.shape[:2]

    def fragments(self, col, row, depth, rgb, ztest: bool = True) -> None:
        """Write integer-pixel fragments; with ``ztest`` the nearest one a
        pixel wins (ties to the earliest), else the last one drawn."""
        h, w = self.shape
        col, row = np.asarray(col, np.int64), np.asarray(row, np.int64)
        ok = (col >= 0) & (col < w) & (row >= 0) & (row < h)
        col, row, depth, rgb = col[ok], row[ok], np.asarray(depth)[ok], np.asarray(rgb)[ok]
        if not len(col):
            return
        flat = row * w + col
        if ztest:
            order = np.lexsort((np.arange(len(flat)), -depth, flat))
            flat, depth, rgb = flat[order], depth[order], rgb[order]
            first = np.ones(len(flat), bool)
            first[1:] = flat[1:] != flat[:-1]
            flat, depth, rgb = flat[first], depth[first], rgb[first]
            zb = self.depth.reshape(-1)
            near = depth > zb[flat]
            flat, depth, rgb = flat[near], depth[near], rgb[near]
            zb[flat] = depth
        else:
            # the last fragment a pixel wins
            rev = np.arange(len(flat))[::-1]
            _, last = np.unique(flat[rev], return_index=True)
            keep = rev[last]
            flat, rgb = flat[keep], rgb[keep]
        self.rgb.reshape(-1, 3)[flat] = rgb

    def splats(self, col, row, depth, rgb, radius: int, ztest: bool = True) -> None:
        """Square splats of ``2 * radius + 1`` pixels around each point."""
        c0, r0 = np.rint(col).astype(np.int64), np.rint(row).astype(np.int64)
        offs = np.arange(-radius, radius + 1)
        dc, dr = [o.reshape(-1) for o in np.meshgrid(offs, offs)]
        k = len(dc)
        self.fragments((c0[:, None] + dc).reshape(-1), (r0[:, None] + dr).reshape(-1),
                       np.repeat(depth, k), np.repeat(rgb, k, axis=0), ztest)

    def segments(self, p0, p1, rgb, radius: int = 0) -> None:
        """Line segments between (M, 2) column/row end points, sampled at
        half-pixel steps, ``radius`` pixels thick, drawn over what is there."""
        p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
        for a, b, c in zip(p0, p1, _color_array(rgb, len(p0))):
            n = int(np.ceil(2 * np.abs(b - a).max())) + 1
            pts = a + np.linspace(0.0, 1.0, n)[:, None] * (b - a)
            self.splats(pts[:, 0], pts[:, 1], np.zeros(n), np.tile(c, (n, 1)), radius,
                        ztest=False)

    def triangles(self, col, row, depth, faces, rgb) -> None:
        """Z-buffered filled triangles; a pixel is covered when its centre
        lies inside (edges included).  ``rgb`` is one colour a face."""
        f = np.asarray(faces, np.int64)
        if not len(f):
            return
        xs, ys, zs = col[f], row[f], depth[f]
        h, w = self.shape
        x0 = np.clip(np.floor(xs.min(1)), 0, w - 1).astype(np.int64)
        x1 = np.clip(np.ceil(xs.max(1)), 0, w - 1).astype(np.int64)
        y0 = np.clip(np.floor(ys.min(1)), 0, h - 1).astype(np.int64)
        y1 = np.clip(np.ceil(ys.max(1)), 0, h - 1).astype(np.int64)
        bw, bh = x1 - x0 + 1, y1 - y0 + 1
        area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
                - (xs[:, 2] - xs[:, 0]) * (ys[:, 1] - ys[:, 0]))
        live = np.nonzero(np.abs(area) > 1e-12)[0]
        # candidate pixels in bounded batches of faces
        start = 0
        counts = (bw * bh)[live]
        while start < len(live):
            stop = start + max(1, int(np.searchsorted(np.cumsum(counts[start:]), 4_000_000)))
            sel = live[start:stop]
            n = bw[sel] * bh[sel]
            fi = np.repeat(sel, n)
            local = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
            px = (x0[fi] + local % bw[fi]).astype(np.float64)
            py = (y0[fi] + local // bw[fi]).astype(np.float64)
            X, Y = xs[fi], ys[fi]
            w0 = (X[:, 1] - px) * (Y[:, 2] - py) - (X[:, 2] - px) * (Y[:, 1] - py)
            w1 = (X[:, 2] - px) * (Y[:, 0] - py) - (X[:, 0] - px) * (Y[:, 2] - py)
            w2 = (X[:, 0] - px) * (Y[:, 1] - py) - (X[:, 1] - px) * (Y[:, 0] - py)
            a = area[fi]
            inside = (w0 * a >= 0) & (w1 * a >= 0) & (w2 * a >= 0)
            z = (w0 * zs[fi, 0] + w1 * zs[fi, 1] + w2 * zs[fi, 2]) / a
            self.fragments(px[inside], py[inside], z[inside], np.asarray(rgb)[fi[inside]])
            start = stop


# ---------------------------------------------------------------------------
# Writers

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> str:
    """8-bit RGB PNG of an (H, W, 3) uint8 array."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def palette_frames(frames: list[np.ndarray]) -> tuple[np.ndarray, list[np.ndarray]]:
    """One 256-entry palette and per-frame index images.  Exact when the
    frames hold at most 256 colours; otherwise every pixel takes the
    nearest colour of a 6 x 7 x 6 cube."""
    flat = np.concatenate([f.reshape(-1, 3) for f in frames])
    key = (flat[:, 0].astype(np.int64) << 16) | (flat[:, 1].astype(np.int64) << 8) | flat[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    palette = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        palette[:len(uniq)] = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
        idx = inv.reshape(-1).astype(np.uint8)
    else:
        levels = [np.round(np.linspace(0, 255, n)).astype(np.int64) for n in (6, 7, 6)]
        cube = np.stack(np.meshgrid(*levels, indexing="ij"), -1).reshape(-1, 3)
        palette[:len(cube)] = cube
        nearest = [np.abs(flat[:, c, None].astype(np.int64) - levels[c]).argmin(1)
                   for c in range(3)]
        idx = ((nearest[0] * 7 + nearest[1]) * 6 + nearest[2]).astype(np.uint8)
    sizes = np.cumsum([f.shape[0] * f.shape[1] for f in frames])[:-1]
    return palette, [i.reshape(f.shape[:2]) for i, f in zip(np.split(idx, sizes), frames)]


def _lzw(indices: np.ndarray) -> bytes:
    """GIF LZW code stream of 8-bit indices (minimum code size 8, variable
    code width up to 12 bits, a clear code when the table is full)."""
    min_size = 8
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    size = min_size + 1
    acc, nbits = clear, size          # the stream starts with a clear code
    table: dict[int, int] = {}
    get = table.get
    nxt, limit = eoi + 1, 1 << size
    data = indices.reshape(-1).tobytes()
    prefix = data[0]
    for byte in data[1:]:
        key = (prefix << 8) | byte
        code = get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << nbits
        nbits += size
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > limit and size < 12:
                size += 1
                limit <<= 1
        else:
            acc |= clear << nbits
            nbits += size
            table.clear()
            nxt, size, limit = eoi + 1, min_size + 1, 1 << (min_size + 1)
        if nbits >= 64:
            n = nbits >> 3
            out += (acc & ((1 << (n << 3)) - 1)).to_bytes(n, "little")
            acc >>= n << 3
            nbits -= n << 3
        prefix = byte
    acc |= prefix << nbits
    nbits += size
    acc |= eoi << nbits
    nbits += size
    out += acc.to_bytes((nbits + 7) >> 3, "little")
    return bytes(out)


def write_gif(path: str, frames: list[np.ndarray], duration_ms: int) -> str:
    """Looping GIF89a of (H, W, 3) uint8 frames, one global palette."""
    palette, indexed = palette_frames(frames)
    h, w = frames[0].shape[:2]
    delay = int(round(duration_ms / 10))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for idx in indexed:
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        code = _lzw(idx)
        parts += [bytes([len(code[i:i + 255])]) + code[i:i + 255]
                  for i in range(0, len(code), 255)]
        parts.append(b"\x00")
    parts.append(b"\x3b")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(parts))
    return path


# ---------------------------------------------------------------------------
# 2-D plots

class _Plot:
    """A framed plot box on a canvas, mapping data to pixels."""

    def __init__(self, canvas: Canvas, box, xlim, ylim, logy: bool = False):
        self.canvas, self.box, self.logy = canvas, box, logy
        self.xlim = self._pad(xlim)
        self.ylim = self._pad(np.log10(ylim) if logy else ylim)

    @staticmethod
    def _pad(lim):
        lo, hi = float(lim[0]), float(lim[1])
        if hi <= lo:
            lo, hi = lo - 0.5, hi + 0.5
        m = 0.05 * (hi - lo)
        return lo - m, hi + m

    def to_px(self, x, y):
        left, top, right, bottom = self.box
        y = np.log10(y) if self.logy else np.asarray(y, np.float64)
        px = left + (np.asarray(x, np.float64) - self.xlim[0]) / (self.xlim[1] - self.xlim[0]) \
            * (right - left)
        py = bottom - (y - self.ylim[0]) / (self.ylim[1] - self.ylim[0]) * (bottom - top)
        return np.stack([px, py], -1)

    def frame(self, grid: bool = True):
        left, top, right, bottom = self.box
        if grid:
            for t in np.linspace(0.0, 1.0, 6)[1:-1]:
                x, y = left + t * (right - left), top + t * (bottom - top)
                self.canvas.segments([[x, top]], [[x, bottom]], GRIDGRAY)
                self.canvas.segments([[left, y]], [[right, y]], GRIDGRAY)
        corners = np.array([[left, top], [right, top], [right, bottom], [left, bottom]], float)
        self.canvas.segments(corners, np.roll(corners, -1, axis=0), BLACK)

    def line(self, x, y, rgb=C0, marker: int = 0):
        p = self.to_px(x, y)
        if len(p) > 1:
            self.canvas.segments(p[:-1], p[1:], rgb, radius=1)
        if marker:
            self.canvas.splats(p[:, 0], p[:, 1], np.zeros(len(p)), _color_array(rgb, len(p)),
                               marker, ztest=False)


def _plot_box(width: int, height: int):
    return (0.125 * width, 0.11 * height, 0.9 * width, 0.88 * height)


def plot_silhouette_scores(nls, scores, path: str) -> str:
    """Silhouette score against link count: a line with round markers."""
    c = Canvas(6 * PIXELS_PER_INCH, 4 * PIXELS_PER_INCH)
    x, y = np.asarray(nls, np.float64), np.asarray(scores, np.float64)
    p = _Plot(c, _plot_box(*c.shape[::-1]), (x.min(), x.max()), (y.min(), y.max()))
    p.frame()
    p.line(x, y, marker=3)
    return write_png(path, c.rgb)


def plot_distance_map(sum_map: np.ndarray, path: str) -> str:
    """``1 - sum_map`` as a grid in the Blues ramp (normalised to its own
    range, as ``imshow`` does), with a colour bar beside it."""
    img = 1.0 - np.asarray(sum_map, np.float64)
    size = 5 * PIXELS_PER_INCH
    c = Canvas(size, size)
    lo, hi = float(img.min()), float(img.max())
    norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    n_r, n_c = img.shape
    side = int(0.75 * size)
    cell = max(1, side // max(n_r, n_c))
    top, left = (size - cell * n_r) // 2, int(0.05 * size)
    block = np.repeat(np.repeat(blues_colors(norm), cell, axis=0), cell, axis=1)
    c.rgb[top:top + block.shape[0], left:left + block.shape[1]] = block
    bar_left = left + cell * n_c + int(0.05 * size)
    ramp = blues_colors(np.linspace(1.0, 0.0, cell * n_r))
    c.rgb[top:top + cell * n_r, bar_left:bar_left + int(0.04 * size)] = ramp[:, None]
    return write_png(path, c.rgb)


def plot_loss_history(losses, path: str, lrs=None) -> str:
    """The finite losses over epochs; with ``lrs`` a second panel of the
    learning rate on a log axis."""
    rows = 2 if lrs is not None else 1
    w, h = 8 * PIXELS_PER_INCH, 4 * PIXELS_PER_INCH
    c = Canvas(w, h * rows)
    losses = np.asarray(losses, np.float64)
    y = losses[np.isfinite(losses)]
    x = np.arange(len(y))
    box = _plot_box(w, h)
    p = _Plot(c, box, (0, max(len(y) - 1, 0)), (y.min(), y.max()) if len(y) else (0, 1))
    p.frame()
    if len(y):
        p.line(x, y)
    if lrs is not None:
        lr = np.asarray(lrs, np.float64)
        box2 = (box[0], box[1] + h, box[2], box[3] + h)
        q = _Plot(c, box2, (0, max(len(lr) - 1, 0)), (lr.min(), lr.max()), logy=True)
        q.frame()
        q.line(np.arange(len(lr)), lr)
    return write_png(path, c.rgb)


# ---------------------------------------------------------------------------
# 3-D renders

def _radius(point_size: float) -> int:
    """Splat radius in pixels for a matplotlib marker area ``s``."""
    return max(0, int(round(np.sqrt(point_size) / 2)))


def draw_cloud(points: np.ndarray, colors=None, point_size: float = 1.0, limits_of=None,
               size: int = 6 * PIXELS_PER_INCH) -> np.ndarray:
    """The (size, size, 3) image of a point cloud; the cube comes from
    ``limits_of`` (default the points)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    view = View(*cube_limits(pts if limits_of is None else limits_of), size)
    c = Canvas(size, size)
    col, row, depth = view.project(pts)
    c.splats(col, row, depth, _color_array(colors, len(pts)), _radius(point_size))
    return c.rgb


def render_cloud(points: np.ndarray, path: str, colors=None, title=None,
                 point_size: float = 1.0) -> str:
    return write_png(path, draw_cloud(points, colors, point_size))


def render_clusters(points: np.ndarray, labels: np.ndarray, path: str,
                    num_clusters: int | None = None, title=None) -> str:
    """Cluster-coloured cloud (jet over the cluster ids)."""
    labels = np.asarray(labels)
    k = num_clusters or int(labels.max()) + 1
    return render_cloud(points, path, colors=jet_colors(labels / max(k - 1, 1)), title=title)


def render_kinematic_tree(
    coords: np.ndarray,            # (K, >=3) cluster centres
    groups: list,                  # link groups (sets of cluster ids)
    edges: list[tuple[int, int]],  # cluster adjacency edges
    path: str,
    joints=None,                   # optional list with .global_pos/.global_axis
    axis_len: float = 0.08,
) -> str:
    """Link-coloured cluster centres, the cluster graph's edges in gray and
    each joint's axis in red with a red cross at its position."""
    size = 7 * PIXELS_PER_INCH
    pts = np.asarray(coords, np.float64)[:, :3]
    view = View(*cube_limits(pts), size)
    c = Canvas(size, size)
    col, row, depth = view.project(pts)
    for gi, group in enumerate(groups):
        sel = np.array(sorted(group), np.int64)
        rgb = jet_colors(np.full(len(sel), gi / max(len(groups) - 1, 1)))
        c.splats(col[sel], row[sel], depth[sel], rgb, _radius(40))
    screen = np.stack([col, row], -1)
    if edges:
        a, b = np.array(edges, np.int64).T
        c.segments(screen[a], screen[b], GRAY)
    for j in joints or []:
        p = np.asarray(j.global_pos, np.float64)[:3]
        d = np.asarray(j.global_axis, np.float64)[:3]
        d = d / max(np.linalg.norm(d), 1e-9) * axis_len
        ec, er, _ = view.project(np.stack([p - d, p + d]))
        c.segments([[ec[0], er[0]]], [[ec[1], er[1]]], RED, radius=1)
        pc, pr, _ = view.project(p[None])
        r = _radius(60)
        cross = np.array([[-r, -r, r, r], [-r, r, r, -r]], np.float64)
        for dc0, dr0, dc1, dr1 in cross:
            c.segments([[pc[0] + dc0, pr[0] + dr0]], [[pc[0] + dc1, pr[0] + dr1]], RED)
    return write_png(path, c.rgb)


def render_mesh(mesh, path: str, title=None) -> str:
    """Flat-shaded render of a TriMesh: z-buffered triangles, each light gray
    times ``0.35 + 0.65 |n . eye|``."""
    v, f = np.asarray(mesh.vertices, np.float64), np.asarray(mesh.faces, np.int64)
    size = 6 * PIXELS_PER_INCH
    view = View(*cube_limits(v), size)
    c = Canvas(size, size)
    col, row, depth = view.project(v)
    if len(f):
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        shade = 0.35 + 0.65 * np.abs(n @ view.eye)
        rgb = np.round(np.asarray(LIGHTGRAY, np.float64)[None] * shade[:, None]).astype(np.uint8)
        c.triangles(col, row, depth, f, rgb)
    return write_png(path, c.rgb)


def animate_clouds(clouds: list[np.ndarray], path: str, labels=None,
                   fps: int = 4, point_size: float = 1.0) -> str:
    """GIF of a point-cloud sequence: 500 x 500 frames, all in the cube of
    every cloud's points; with ``labels`` each cloud is jet-coloured by its
    own labels."""
    allpts = np.concatenate([np.asarray(c, np.float64).reshape(-1, 3) for c in clouds])
    frames = []
    for i, cloud in enumerate(clouds):
        colors = None
        if labels is not None:
            lab = np.asarray(labels[i])
            colors = jet_colors(lab / max(int(lab.max()), 1))
        frames.append(draw_cloud(cloud, colors, point_size, limits_of=allpts,
                                 size=5 * PIXELS_PER_INCH))
    return write_gif(path, frames, int(1000 / fps))


def replay_posed_meshes(
    link_dir: str,
    out_path: str,
    start: int = 0,
    end: int | None = None,
    fps: int = 4,
) -> str:
    """Replay recovered link meshes posed by the per-step link matrices
    (headless GIF)."""
    import glob as globmod

    from .io.mesh_io import load_stl, sample_surface

    m_files = sorted(globmod.glob(os.path.join(link_dir, "matrix", "*.npy")))[start:end]
    stl_files = sorted(globmod.glob(os.path.join(link_dir, "[0-9]*.stl")))
    rng = np.random.default_rng(0)
    link_samples = [sample_surface(load_stl(f), 800, rng) for f in stl_files]
    clouds, labels = [], []
    for mf in m_files:
        mats = np.load(mf)
        step_pts, step_lab = [], []
        for i, pts in enumerate(link_samples):
            T = mats[i]
            step_pts.append(pts @ T[:3, :3].T + T[:3, 3])
            step_lab.append(np.full(len(pts), i))
        clouds.append(np.concatenate(step_pts))
        labels.append(np.concatenate(step_lab))
    return animate_clouds(clouds, out_path, labels=labels, fps=fps)


def urdf_snapshot(
    urdf_path: str,
    out_path: str,
    q: dict | None = None,
    num_points: int = 4000,
    asset_root: str | None = None,
) -> str:
    """A URDF at a configuration, gray surface points with each revolute
    joint's axis in red (no joint names)."""
    from .urdf.fk import joint_world_frames, link_points_world, sample_link_surfaces
    from .urdf.parser import load_urdf

    model = load_urdf(urdf_path, asset_root=asset_root)
    samples = sample_link_surfaces(model, total_points=num_points * 4)
    pts = link_points_world(model, samples, q or {})
    frames = joint_world_frames(model, q or {})

    size = 7 * PIXELS_PER_INCH
    view = View(*cube_limits(pts), size)
    c = Canvas(size, size)
    shown = pts[:: max(1, len(pts) // num_points)]
    col, row, depth = view.project(shown)
    c.splats(col, row, depth, _color_array(GRAY, len(shown)), _radius(1))
    span = max(float(np.ptp(pts, axis=0).max()), 1e-6)
    for f in frames:
        d = f.axis / max(np.linalg.norm(f.axis), 1e-9) * 0.12 * span
        ec, er, _ = view.project(np.stack([f.position - d, f.position + d]))
        c.segments([[ec[0], er[0]]], [[ec[1], er[1]]], RED, radius=1)
    return write_png(out_path, c.rgb)


def sweep_joint_gif(
    urdf_path: str,
    joint_name: str,
    out_path: str,
    num_frames: int = 16,
    amplitude: float = 1.0,
    num_points: int = 2000,
    asset_root: str | None = None,
) -> str:
    """Sine-sweep one joint of a URDF and record a GIF."""
    from .urdf.fk import link_points_world, sample_link_surfaces
    from .urdf.parser import load_urdf

    model = load_urdf(urdf_path, asset_root=asset_root)
    samples = sample_link_surfaces(model, total_points=num_points * 4)
    clouds = []
    for t in range(num_frames):
        q = {joint_name: amplitude * np.sin(2 * np.pi * t / num_frames)}
        clouds.append(link_points_world(model, samples, q))
    return animate_clouds(clouds, out_path)
