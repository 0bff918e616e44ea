"""Render the reference notebooks' figures from a trained model
(counterpart of ``deepcgp_tpu/utils/figures.py``), with no plotting
library: each figure is rasterised in numpy and written as an RGB PNG by
``utils/events.encode_png``.

The reference's analysis notebooks (`notebooks/Inspect.ipynb`,
`notebooks/convgp MNIST.ipynb`) produce three figure families: the
inducing-patch tilings, the patch-embedding scatter and the
noise-robustness curve.  ``utils/inspect`` computes them; each function
here writes one PNG and returns its path, under the JAX package's file
names.  There is no font: a figure's title, axis labels, annotated values
and plot frame are stored as PNG ``tEXt`` chunks (``events.png_text``
reads them back).  The frame chunk, 'x0 x1 y0 y1 left top right bottom',
gives the data limits and the plot box in pixels, so a reader can project
a data point onto the image.
"""

from __future__ import annotations

import os

import numpy as np

from deepcgp_tpu_torch.utils import events
from deepcgp_tpu_torch.utils import inspect as insp

# The JAX package's two-series pair (CVD-safe blue/orange); a
# single-series chart uses the first hue alone.
PRIMARY = (0x2f, 0x6f, 0xde)
SECONDARY = (0xe8, 0x91, 0x3a)
GRID = (0xeb, 0xeb, 0xeb)
AXES = (0xbb, 0xbb, 0xbb)
WHITE = (0xff, 0xff, 0xff)


def _disc(radius: int):
    r = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(r, r, indexing='ij')
    inside = dy * dy + dx * dx <= radius * radius + radius
    return dy[inside], dx[inside]


class Canvas:
    """A white RGB raster with a plot box inside a margin and data limits
    mapped onto it (y up)."""

    def __init__(self, width: int, height: int, xlim, ylim,
                 margin: int = 40):
        self.pixels = np.full((height, width, 3), 255, np.uint8)
        self.box = (margin, margin // 2, width - margin // 2,
                    height - margin)                  # left top right bottom
        x0, x1 = (float(v) for v in xlim)
        y0, y1 = (float(v) for v in ylim)
        self.xlim = (x0, x1) if x1 > x0 else (x0 - 0.5, x0 + 0.5)
        self.ylim = (y0, y1) if y1 > y0 else (y0 - 0.5, y0 + 0.5)

    def frame(self) -> str:
        return ' '.join(repr(v) for v in (*self.xlim, *self.ylim, *self.box))

    def to_px(self, x, y):
        """(rows, cols) of data points, rounded to the nearest pixel."""
        return project(np.asarray(x), np.asarray(y), self.xlim, self.ylim,
                       self.box)

    def _stamp(self, rows, cols, radius: int, color) -> None:
        dy, dx = _disc(radius)
        rr = (np.asarray(rows)[:, None] + dy[None]).ravel()
        cc = (np.asarray(cols)[:, None] + dx[None]).ravel()
        H, W, _ = self.pixels.shape
        keep = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        self.pixels[rr[keep], cc[keep]] = color

    def grid(self, lines: int = 5) -> None:
        """Light grid lines at ``lines`` + 1 even steps, the left and
        bottom axes darker."""
        left, top, right, bottom = self.box
        for t in np.linspace(0.0, 1.0, lines + 1):
            self.pixels[int(round(top + t * (bottom - top))),
                        left:right + 1] = GRID
            self.pixels[top:bottom + 1,
                        int(round(left + t * (right - left)))] = GRID
        self.pixels[bottom, left:right + 1] = AXES
        self.pixels[top:bottom + 1, left] = AXES

    def dots(self, x, y, radius: int, color, ring=None) -> None:
        """Filled discs at the data points, each inside a one-pixel ring
        of ``ring`` when given."""
        rows, cols = self.to_px(x, y)
        if ring is not None:
            self._stamp(rows, cols, radius + 1, ring)
        self._stamp(rows, cols, radius, color)

    def polyline(self, x, y, color, radius: int = 1) -> None:
        rows, cols = self.to_px(x, y)
        for r0, c0, r1, c1 in zip(rows[:-1], cols[:-1], rows[1:], cols[1:]):
            n = 2 * max(abs(r1 - r0), abs(c1 - c0)) + 1
            t = np.linspace(0.0, 1.0, n)
            self._stamp(np.rint(r0 + t * (r1 - r0)).astype(int),
                        np.rint(c0 + t * (c1 - c0)).astype(int), radius,
                        color)

    def write(self, path: str, text: dict) -> str:
        with open(path, 'wb') as f:
            f.write(events.encode_png(self.pixels,
                                      dict(text, Frame=self.frame())))
        return path


def project(x, y, xlim, ylim, box):
    """Data coordinates -> (rows, cols) of the plot ``box`` (left, top,
    right, bottom) for the limits ``xlim``, ``ylim``."""
    left, top, right, bottom = box
    cols = left + (x - xlim[0]) / (xlim[1] - xlim[0]) * (right - left)
    rows = bottom - (y - ylim[0]) / (ylim[1] - ylim[0]) * (bottom - top)
    return np.rint(rows).astype(int), np.rint(cols).astype(int)


def _padded(values, frac: float = 0.05):
    lo, hi = float(np.min(values)), float(np.max(values))
    pad = (hi - lo) * frac or 0.5
    return lo - pad, hi + pad


def grid_pixels(grid: np.ndarray) -> np.ndarray:
    """A [0, 1] grey image as uint8 levels, rounded."""
    return np.rint(np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)


def grid_scale(grid: np.ndarray, target: int = 480) -> int:
    """The integer upscaling of a tiling: about ``target`` pixels on its
    longer side, at least 1."""
    return max(1, target // max(grid.shape))


def render_inducing_grid(layer, path: str, cols: int = 16) -> str:
    """Inducing-patch tiling (the MNIST notebook's grids) -> PNG: the grey
    levels of ``inspect.inducing_patch_grid``, upscaled by an integer
    factor with nearest neighbours."""
    grid = insp.inducing_patch_grid(layer, cols=cols)
    scale = grid_scale(grid)
    grey = np.kron(grid_pixels(grid), np.ones((scale, scale), np.uint8))
    rgb = np.repeat(grey[..., None], 3, axis=2)
    with open(path, 'wb') as f:
        f.write(events.encode_png(rgb, {
            'Title': f'Inducing patches (M={layer.Z.shape[0]})',
            'Scale': str(scale)}))
    return path


def render_patch_embedding(layer, NHWC_X, path: str, seed: int = 0) -> str:
    """2-D embedding of inducing patches over data patches -> PNG scatter
    (Inspect.ipynb's embedding figure): data patches as small dots in the
    first hue, inducing patches as larger white-ringed dots in the second,
    drawn last."""
    emb_z, emb_d = insp.patch_embedding(layer, NHWC_X, seed=seed)
    both = np.concatenate([emb_z, emb_d])
    canvas = Canvas(600, 500, _padded(both[:, 0]), _padded(both[:, 1]))
    canvas.grid()
    canvas.dots(emb_d[:, 0], emb_d[:, 1], 1, PRIMARY)
    canvas.dots(emb_z[:, 0], emb_z[:, 1], 3, SECONDARY, ring=WHITE)
    return canvas.write(path, {
        'Title': 'Patch embedding: inducing vs data',
        'Legend': 'data patches (#2f6fde), inducing patches (#e8913a)'})


def render_noise_robustness(accuracies: dict, path: str) -> str:
    """Accuracy-under-noise curve (Inspect.ipynb's robustness sweep) ->
    PNG: a polyline with markers, y from 0 to 1.05, each accuracy in a
    ``tEXt`` chunk.  ``accuracies``: {sigma: accuracy}, as
    ``inspect.noise_robustness`` returns it."""
    sigmas = sorted(accuracies)
    accs = [accuracies[s] for s in sigmas]
    canvas = Canvas(550, 400, _padded(sigmas), (0.0, 1.05))
    canvas.grid()
    canvas.polyline(sigmas, accs, PRIMARY)
    canvas.dots(sigmas, accs, 4, PRIMARY)
    return canvas.write(path, {
        'Title': 'Noise robustness', 'X label': 'input noise sigma',
        'Y label': 'test accuracy',
        **{f'sigma={s:g}': f'{a:.3f}' for s, a in zip(sigmas, accs)}})


def render_run_figures(run_dir: str, model, NHWC_X_train, X_test, Y_test,
                       seed: int = 0, noise_levels=(0.0, 0.25, 0.5, 1.0),
                       max_eval_points: int = 512,
                       accuracies: dict | None = None) -> list:
    """Render every applicable figure of a trained model into ``run_dir``;
    returns the written paths.  A plain-RBF last layer has no patch view,
    so the patch figures cover the conv layers only.  ``accuracies``
    optionally supplies a noise-robustness sweep already run; otherwise
    it runs with draws seeded from ``seed``."""
    paths = []
    for i, layer in enumerate(model.layers):
        view = getattr(layer, 'view', None) or \
            getattr(getattr(layer, 'kernel', None), 'view', None)
        if view is None:
            continue
        paths.append(render_inducing_grid(
            layer, os.path.join(run_dir, f'inducing_grid_layer{i}.png')))
        if i == 0:
            paths.append(render_patch_embedding(
                layer, NHWC_X_train,
                os.path.join(run_dir, 'patch_embedding_layer0.png')))
    if accuracies is None:
        accuracies = insp.noise_robustness(model, X_test, Y_test,
                                           noise_levels=noise_levels,
                                           max_points=max_eval_points,
                                           seed=seed)
    paths.append(render_noise_robustness(
        accuracies, os.path.join(run_dir, 'noise_robustness.png')))
    return paths
