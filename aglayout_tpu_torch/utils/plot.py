"""Line charts drawn with PIL, for the tools' curves.

The card's host has PIL but not matplotlib, so the tools' plots (the loss
curves of `tools/train_evidence.py`, the metric panels of
`tools/quality_curve.py`) are drawn here: a grid of panels, each with its
title, x label, grid lines, tick values, and one line a series with a
legend. The JAX package's tools draw the same panels with matplotlib.
"""

from __future__ import annotations

import math

# matplotlib's default cycle (tab10)
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189))


def _ticks(lo: float, hi: float, n: int = 5):
    """n tick values from lo to hi, and their labels with as many digits as
    tell them apart."""
    values = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    digits = 3 + max(0, math.ceil(math.log10(max(abs(lo), abs(hi)) / (hi - lo))))
    return [(v, f"{v:.{digits}g}") for v in values]


def plot_panels(panels, path: str, cols: int, title: str | None = None):
    """Draw `panels` in a grid of `cols` columns and save a PNG at `path`.
    Each panel is (title, xlabel, series), a series (label, xs, ys, dashed);
    a series without a label has no legend entry."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    pw, ph = 500, 400  # a panel's pixels
    rows = -(-len(panels) // cols)
    top = 30 if title else 0
    img = Image.new("RGB", (cols * pw, rows * ph + top), "white")
    draw = ImageDraw.Draw(img)
    if title:
        draw.text((cols * pw // 2, 8), title, fill="black", font=font, anchor="mt")
    left, right, upper, lower = 70, 15, 30, 45  # the plot area's margins in a panel
    for n, (ptitle, xlabel, series) in enumerate(panels):
        ox, oy = (n % cols) * pw, (n // cols) * ph + top
        x0, y0, x1, y1 = ox + left, oy + upper, ox + pw - right, oy + ph - lower
        xs = [x for _, sx, _, _ in series for x in sx]
        ys = [y for _, _, sy, _ in series for y in sy]
        if not xs:
            continue
        xlo, xhi = min(xs), max(xs)
        ylo, yhi = min(ys), max(ys)
        pad = 0.05 * (yhi - ylo) or 0.05 * abs(yhi) or 1.0
        ylo, yhi = ylo - pad, yhi + pad
        xhi = xhi if xhi > xlo else xlo + 1

        def at(x, y):
            return (x0 + (x - xlo) / (xhi - xlo) * (x1 - x0),
                    y1 - (y - ylo) / (yhi - ylo) * (y1 - y0))

        for v, text in _ticks(ylo, yhi):
            _, py = at(xlo, v)
            draw.line([(x0, py), (x1, py)], fill=(225, 225, 225))
            draw.text((x0 - 5, py), text, fill="black", font=font, anchor="rm")
        for v, text in _ticks(xlo, xhi):
            px, _ = at(v, ylo)
            draw.line([(px, y0), (px, y1)], fill=(225, 225, 225))
            draw.text((px, y1 + 5), text, fill="black", font=font, anchor="mt")
        draw.rectangle([x0, y0, x1, y1], outline="black")
        draw.text(((x0 + x1) / 2, oy + 8), ptitle, fill="black", font=font, anchor="mt")
        draw.text(((x0 + x1) / 2, y1 + 25), xlabel, fill="black", font=font, anchor="mt")
        legend = 0
        for k, (label, sx, sy, dashed) in enumerate(series):
            color = COLORS[k % len(COLORS)]
            pts = [at(x, y) for x, y in zip(sx, sy)]
            if len(pts) < 20:  # a sparse curve: its points marked
                for px, py in pts:
                    draw.ellipse([px - 2, py - 2, px + 2, py + 2], fill=color)
            for i, (a, b) in enumerate(zip(pts[:-1], pts[1:])):
                if not dashed or i % 2 == 0:
                    draw.line([a, b], fill=color, width=1)
            if label:
                draw.text((x1 - 8, y0 + 8 + 14 * legend), label, fill=color, font=font,
                          anchor="ra")
                legend += 1
    img.save(path)
