"""Observability artifacts: metric curves and debug image strips, the
port's copy of ``multimodal_fusion_fpn_tpu/viz.py`` without matplotlib or
PIL.

* :class:`CurvePlotter` keeps one series per (metric, train/val) and
  writes ``curves.json`` (byte for byte the JAX package's, atomically) and
  ``curves.svg``: one panel per metric with its title, one ``<polyline>``
  per series in the JAX colour table, dashed for "(val)", and a legend.
* :func:`debug_batch` writes a strip PNG with the JAX panels: one row per
  batch element, one 256 x 256 column per modality (depth-summed, resized
  by :mod:`.ops.resize`, normalised, with the mask border of
  ``scipy.ndimage.binary_erosion`` by a radius-2 disk overlaid on the
  other panels) under a 32-row label band.  The labels are drawn from a
  small bitmap font kept here (JAX draws them with PIL's default font):
  1 on the glyphs, 0 elsewhere, as JAX's inverted grey canvas.
"""

import json
import math
import os
import time
from os.path import join
from typing import Dict, List, Optional
from xml.sax.saxutils import escape

import numpy as np

from multimodal_fusion_fpn_torch.data.imageio_utils import imsave
from multimodal_fusion_fpn_torch.ops.resize import resize as host_resize
from multimodal_fusion_fpn_torch.utils import normalize_data

PYPLOT_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]

IMAGE_KEYS = ["weight", "mask", "prediction", "image", "slo", "faf"]
LABEL_SIZE = (256, 32)   # (width, height) of one label, as JAX's

# 5 x 9 lowercase glyphs (baseline on row 6, descenders on rows 7-8): the
# letters of IMAGE_KEYS
_GLYPHS = {
    "a": "..... ..... .###. ....# .#### #...# .#### ..... .....",
    "c": "..... ..... .###. #.... #.... #.... .###. ..... .....",
    "d": "....# ....# .#### #...# #...# #...# .#### ..... .....",
    "e": "..... ..... .###. #...# ##### #.... .###. ..... .....",
    "f": "..##. .#... ####. .#... .#... .#... .#... ..... .....",
    "g": "..... ..... .#### #...# #...# #...# .#### ....# .###.",
    "h": "#.... #.... ####. #...# #...# #...# #...# ..... .....",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###. ..... .....",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#. ..... .....",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###. ..... .....",
    "m": "..... ..... ##.#. #.#.# #.#.# #.#.# #.#.# ..... .....",
    "n": "..... ..... ####. #...# #...# #...# #...# ..... .....",
    "o": "..... ..... .###. #...# #...# #...# .###. ..... .....",
    "p": "..... ..... ####. #...# #...# #...# ####. #.... #....",
    "r": "..... ..... #.##. ##..# #.... #.... #.... ..... .....",
    "s": "..... ..... .#### #.... .###. ....# ####. ..... .....",
    "t": ".#... .#... ####. .#... .#... .#..# ..##. ..... .....",
    "w": "..... ..... #...# #...# #.#.# #.#.# .#.#. ..... .....",
}
_GLYPH_SCALE = 2


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS[ch].split()
    return np.array([[c == "#" for c in r] for r in rows], np.float64)


def _disk(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (yy ** 2 + xx ** 2) <= radius ** 2


def text_phantom(text: str, size=LABEL_SIZE) -> np.ndarray:
    """``text`` (letters of the font) centred on a (height, width) =
    (size[1], size[0]) array: 1 on the glyphs, 0 elsewhere."""
    w_size, h_size = size
    glyphs = [np.kron(_glyph(c), np.ones((_GLYPH_SCALE,) * 2))
              for c in text]
    gap = np.zeros((glyphs[0].shape[0], _GLYPH_SCALE))
    line = np.concatenate(
        [p for g in glyphs for p in (g, gap)][:-1], axis=1)
    th, tw = line.shape
    out = np.zeros((h_size, w_size))
    y0, x0 = (h_size - th) // 2, (w_size - tw) // 2
    out[y0:y0 + th, x0:x0 + tw] = line
    return out


class CurvePlotter:
    def __init__(self, model_path: str, train_keys: List[str],
                 val_keys: List[str]):
        self.model_path = model_path
        self.curves: Dict[str, list] = {}
        self.metric_colors: Dict[str, str] = {}
        self.metric_figures = []
        colors = list(PYPLOT_COLORS)
        for keys, tag in ((train_keys, "train"), (val_keys, "val")):
            for m in keys:
                if m not in self.metric_figures:
                    self.metric_figures.append(m)
                self.curves[f"{m} ({tag})"] = []
                if m not in self.metric_colors:
                    self.metric_colors[m] = colors.pop(0)

    def append(self, key: str, value: float):
        self.curves.setdefault(key, []).append(float(value))

    def load(self, upto: Optional[int] = None):
        """Restore the history of an earlier run's ``curves.json`` (exact
        resume); ``upto`` keeps that many epochs of each series.  A
        missing or truncated file is ignored."""
        try:
            with open(join(self.model_path, "curves.json")) as f:
                saved = json.load(f)
        except (FileNotFoundError, ValueError):
            return
        for k, v in saved.items():
            self.curves[k] = list(v)[:upto] if upto is not None else list(v)

    def save(self):
        if not self.metric_figures:
            return
        with open(join(self.model_path, "curves.svg"), "w") as f:
            f.write(self.svg())
        # atomic: a kill during the dump must not leave a truncated
        # curves.json for --resume
        path = join(self.model_path, "curves.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.curves, f)
        os.replace(tmp, path)

    def svg(self) -> str:
        """The curves as an SVG document: one 800 x 300 panel per metric."""
        width, height = 800, 300
        left, right, top, bottom = 60, 180, 30, 30
        pw, ph = width - left - right, height - top - bottom
        out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
               f'height="{height * len(self.metric_figures)}">',
               f'<rect width="100%" height="100%" fill="white"/>']
        for i, mf in enumerate(self.metric_figures):
            y0 = i * height
            keys = [k for k in self.curves if mf in k]
            vals = [v for k in keys for v in self.curves[k]
                    if math.isfinite(v)]
            lo, hi = (min(vals), max(vals)) if vals else (0.0, 1.0)
            if hi - lo < 1e-12:
                lo, hi = lo - 0.5, hi + 0.5
            n = max([len(self.curves[k]) for k in keys] + [1])
            out.append(f'<text x="{left + pw / 2}" y="{y0 + top - 10}" '
                       f'text-anchor="middle" font-size="16">'
                       f'{escape(mf)}</text>')
            out.append(f'<rect x="{left}" y="{y0 + top}" width="{pw}" '
                       f'height="{ph}" fill="none" stroke="black"/>')
            for v, yy in ((hi, y0 + top), (lo, y0 + top + ph)):
                out.append(f'<text x="{left - 5}" y="{yy + 4}" '
                           f'text-anchor="end" font-size="11">{v:.4g}'
                           f'</text>')
            for j, k in enumerate(keys):
                pts = []
                for e, v in enumerate(self.curves[k]):
                    if not math.isfinite(v):
                        continue
                    x = left + (pw * e / (n - 1) if n > 1 else pw / 2)
                    y = y0 + top + ph * (hi - v) / (hi - lo)
                    pts.append(f"{x:.2f},{y:.2f}")
                color = self.metric_colors[k.split(" ")[0]]
                dash = ' stroke-dasharray="6,4"' if "(val)" in k else ""
                out.append(f'<polyline fill="none" stroke="{color}" '
                           f'stroke-width="2"{dash} points="'
                           f'{" ".join(pts)}"><title>{escape(k)}</title>'
                           f'</polyline>')
                ly = y0 + top + 15 + 18 * j
                out.append(f'<line x1="{left + pw + 10}" y1="{ly}" '
                           f'x2="{left + pw + 40}" y2="{ly}" '
                           f'stroke="{color}" stroke-width="2"{dash}/>')
                out.append(f'<text x="{left + pw + 45}" y="{ly + 4}" '
                           f'font-size="12">{escape(k)}</text>')
        out.append("</svg>")
        return "\n".join(out) + "\n"


def debug_batch(batch: dict, save_dir: str,
                name_hint: Optional[str] = None) -> str:
    """Save a labelled strip PNG: one row per batch element, one column
    per modality of IMAGE_KEYS present as a 5-dim array (depth-summed,
    resized to 256 x 256, normalised, with the mask border overlaid on the
    later panels), under the labels; returns its path
    (``viz.py:117-171``)."""
    from scipy import ndimage as ndi

    images = {}
    labels = None
    batch_size = np.asarray(batch["prediction"]).shape[0]
    borders_key = "weight" if "weight" in batch.keys() else "mask"

    for b_i in range(batch_size):
        bin_mask_borders = None
        for k in IMAGE_KEYS:
            if k not in batch:
                continue
            order = 0 if k == "mask" else 1
            image = np.asarray(batch[k])
            if image.ndim != 5:
                continue
            image = image[b_i, 0].sum(axis=1)
            image = host_resize(image, (256, 256), order=order,
                                anti_aliasing=False)
            image = normalize_data(image)
            if k == borders_key:
                bin_mask = image > 0.5
                bin_mask_borders = (
                    bin_mask.astype(float)
                    - ndi.binary_erosion(bin_mask,
                                         structure=_disk(2)).astype(float))
            elif bin_mask_borders is not None:
                image[bin_mask_borders == 1] = 1
            images[b_i] = (image if b_i not in images else
                           np.concatenate([images[b_i], image], axis=1))
            if b_i == 0:
                label = text_phantom(k)
                labels = (label if labels is None else
                          np.concatenate([labels, label], axis=1))

    all_images = np.concatenate([v for _, v in images.items()], axis=0)
    all_images = np.concatenate([labels, all_images], axis=0)

    current_ms = name_hint or str(int(time.time() * 1000))
    if "FileSetId" in batch and isinstance(batch["FileSetId"], list):
        suffix = "_".join(fsid[-6:] for fsid in batch["FileSetId"])
        current_ms = f"{current_ms}.{suffix}"
    out = join(save_dir, f"{current_ms}.png")
    imsave(out, (all_images * 255).astype(np.uint8))
    return out
