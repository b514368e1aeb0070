"""Host-side visualization: labeled frames, APNG flipbooks, video frames
and videos, bar charts and HTML galleries (counterpart of put_text,
make_anim, make_video, make_frame, bar_chart and HTML in
nerfactor_tpu/utils/vis.py). PIL only, imported where it is used; a
video is an mp4 where imageio and its ffmpeg backend are installed, else
an animated PNG."""

import os
from os.path import dirname, exists, join

import numpy as np

from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="utils/vis")


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
    """Animated PNG flipbook of the given frames: PIL's encoding (the JAX
    package's bytes) where PIL is installed, else the port's own."""
    os.makedirs(dirname(outpath), exist_ok=True)
    frames = [_to_rgb(x) for x in imgs]
    try:
        from PIL import Image
    except ImportError:
        ioutil.write_apng(frames, outpath, duration_ms=duration_ms)
        return outpath
    frames = [Image.fromarray(x) for x in frames]
    frames[0].save(
        outpath, save_all=True, append_images=frames[1:],
        duration=duration_ms, loop=0, default_image=False)
    return outpath


def make_video(frames, outpath, fps=12):
    """mp4 (through imageio's ffmpeg backend) with an animated-PNG
    fallback; returns the path written, or None without frames."""
    os.makedirs(dirname(outpath), exist_ok=True)
    frames = [_to_rgb(f) for f in frames]
    if not frames:
        logger.warn("No frames to make a video from: %s", outpath)
        return None
    # Even dimensions, as most codecs require
    h, w = frames[0].shape[:2]
    h2, w2 = h - h % 2, w - w % 2
    frames = [f[:h2, :w2] for f in frames]
    try:
        import imageio.v2 as imageio
        writer = imageio.get_writer(outpath, fps=fps)
        for f in frames:
            writer.append_data(f)
        writer.close()
        return outpath
    except Exception as e:  # no imageio or no ffmpeg backend
        alt = outpath.rsplit('.', 1)[0] + '.apng'
        logger.warn("Video backend unavailable (%s); writing %s", e, alt)
        return make_anim(frames, alt, duration_ms=int(1000 / fps))


def make_frame(batch_dir, layout, data_root=None, rgb_embed_light=None):
    """One video frame collaged from a view's ``pred_<name>.png`` files:
    ``layout`` is a tuple of rows of buffer names ('normal', 'lvis',
    'brdf', 'albedo', 'rgb', 'rgb_olat_X', ...). 'nn' is the nearest real
    capture under ``<data_root>/test_phys_nn``, else a white tile; an
    'rgb*' buffer gets ``rgb_embed_light`` inset at its top right. None
    when a buffer is missing."""
    from nerfactor_tpu_torch.ops import img as imgops
    rows = []
    for row_names in layout:
        row_imgs = []
        for name in row_names:
            if name == 'nn':
                cands = ioutil.sortglob(join(data_root, 'test_phys_nn'),
                                        '*_nn_*.png') if data_root else []
                if cands:
                    row_imgs.append(_to_rgb(ioutil.load_img(cands[0])))
                elif row_imgs:
                    row_imgs.append(np.ones_like(row_imgs[0]) * 255)
                continue
            path = join(batch_dir, 'pred_%s.png' % name)
            if not exists(path):
                return None
            img = _to_rgb(ioutil.load_img(path))
            if name.startswith('rgb') and rgb_embed_light is not None:
                img = _embed_light(img, rgb_embed_light)
            row_imgs.append(img)
        if not row_imgs:
            return None
        rows.append(imgops.hconcat(row_imgs))
    return imgops.vconcat(rows)


def _embed_light(img, light_uint):
    """Insets a light thumbnail at the top right of a render."""
    from nerfactor_tpu_torch.ops import img as imgops
    img = img.copy()
    lh = max(1, int(0.2 * img.shape[0]))
    lw = max(1, int(lh / light_uint.shape[0] * light_uint.shape[1]))
    img[:lh, -lw:] = _to_rgb(imgops.resize(
        light_uint.astype(np.float32) / 255.0, new_h=lh, new_w=lw))
    return img


def bar_chart(values, outpath):
    """A bar chart of ``values`` (one series per row) as a 256-px-high
    image, the JAX package's drawing pixel for pixel."""
    values = np.atleast_2d(np.asarray(values, dtype=np.float64))
    n_rows, n_groups = values.shape
    h, w = 256, max(256, 4 * max(n_rows, n_groups))
    img = np.ones((h, w, 3), dtype=np.uint8) * 255
    vmin, vmax = np.nanmin(values), np.nanmax(values)
    vrange = (vmax - vmin) if vmax > vmin else 1.0
    flat = values.T.reshape(-1)  # group-major: the row cycles fastest
    bar_w = max(1, w // max(len(flat), 1))
    colors = [(31, 119, 180), (255, 127, 14), (44, 160, 44)]
    for i, v in enumerate(flat):
        if not np.isfinite(v):
            continue
        bh = int((v - vmin) / vrange * (h - 20))
        x0 = i * bar_w
        img[h - 10 - bh:h - 10, x0:x0 + max(1, bar_w - 1)] = \
            colors[i % n_rows % len(colors)]  # color = series (row)
    ioutil.write_img(img, outpath)
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
