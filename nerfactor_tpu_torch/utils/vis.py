"""Host-side visualization: labeled frames, APNG flipbooks and HTML
galleries (counterpart of put_text, make_anim and HTML in
nerfactor_tpu/utils/vis.py). PIL only, imported where it is used."""

import os
from os.path import dirname

import numpy as np


def _to_uint8(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _to_rgb(img):
    img = _to_uint8(img)
    if img.ndim == 2:
        img = np.dstack([img] * 3)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def put_text(img, text, loc_ratio=0.05, size_ratio=0.05, color=(0, 0, 0)):
    """Draws a label onto an image (uint8 or float); returns uint8 RGB."""
    from PIL import Image, ImageDraw, ImageFont
    img = _to_rgb(img)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    h, w = img.shape[:2]
    xy = (int(loc_ratio * w), int(loc_ratio * h))
    color255 = tuple(int(c * 255) if isinstance(c, float) else int(c)
                     for c in color)
    try:
        font = ImageFont.load_default(size=int(size_ratio * h))
    except (TypeError, ValueError):
        # PIL before 10.1 has no sized default font; a size of 0 (images
        # under 20 px) takes the bitmap one
        font = None
    draw.text(xy, text, fill=color255, font=font)
    return np.array(pil)


def make_anim(imgs, outpath, duration_ms=1000):
    """Animated PNG flipbook of the given frames."""
    from PIL import Image
    os.makedirs(dirname(outpath), exist_ok=True)
    frames = [Image.fromarray(_to_rgb(x)) for x in imgs]
    frames[0].save(
        outpath, save_all=True, append_images=frames[1:],
        duration=duration_ms, loop=0, default_image=False)
    return outpath


class HTML:
    """Self-contained HTML gallery builder."""

    def __init__(self, title="nerfactor_tpu_torch", bgcolor='white',
                 text_color='black'):
        self.title = title
        self.bgcolor = bgcolor
        self.text_color = text_color
        self.headers = []
        self.tables = []

    def add_header(self, text):
        self.headers.append(text)

    def add_table(self):
        table = _HTMLTable()
        self.tables.append(table)
        return table

    def save(self, outpath):
        os.makedirs(dirname(outpath), exist_ok=True)
        parts = [
            "<!DOCTYPE html><html><head><meta charset='utf-8'>",
            "<title>%s</title></head>" % self.title,
            "<body style='background-color:%s;color:%s;"
            "font-family:sans-serif'>" % (self.bgcolor, self.text_color)]
        for htext in self.headers:
            parts.append("<h1>%s</h1>" % htext)
        for table in self.tables:
            parts.append(table.render(outdir=dirname(outpath)))
        parts.append("</body></html>")
        with open(outpath, 'w') as h:
            h.write('\n'.join(parts))
        return outpath


class _HTMLTable:
    def __init__(self):
        self.rows = []

    def add_row(self, cells, types, captions=None):
        self.rows.append((cells, types, captions))

    def render(self, outdir=None):
        out = ["<table border='1' style='border-collapse:collapse'>"]
        for cells, types, captions in self.rows:
            if captions:
                out.append("<tr>" + ''.join(
                    "<td><b>%s</b></td>" % c for c in captions) + "</tr>")
            tds = []
            for cell, typ in zip(cells, types):
                if typ == 'image':
                    src = os.path.relpath(cell, outdir) if outdir else cell
                    tds.append(
                        "<td><a href='%s'><img src='%s' width='256'/></a>"
                        "</td>" % (src, src))
                else:
                    tds.append("<td>%s</td>" % cell)
            out.append("<tr>" + ''.join(tds) + "</tr>")
        out.append("</table>")
        return '\n'.join(out)
