"""Flow, image and disparity file IO: the port's own copy of
``opticalflowfromdepth_tpu/data/frame_io.py``, without cv2.

  * Middlebury ``.flo`` read and write (`frame_utils.py:12-65`);
  * ``.pfm`` read (`frame_utils.py:67-99`);
  * KITTI 16-bit PNG flow ``(uv * 64 + 2^15, valid)`` read and write
    (`frame_utils.py:102-114`) through the PNG codec below;
  * KITTI 16-bit disparity (Pillow's ``I;16``), images and 8-bit gray
    maps (Pillow), and ``read_gen``'s extension dispatch
    (`frame_utils.py:117-131`).

The JAX package reads and writes KITTI PNGs with cv2, which the port
does not depend on, and Pillow reads a 48-bit RGB PNG as 8-bit RGB (it
keeps the high bytes). So :func:`read_png` and :func:`write_png16` are a small PNG
codec in numpy and ``zlib``: 8- and 16-bit gray and RGB, not interlaced,
all five row filters (None, Sub and Up vectorised over each row; Average
and Paeth loop over the pixels of a row, vectorised over a pixel's bytes
and over the rows of a run of such rows). The writer emits 16-bit
big-endian RGB or gray with filter 0.

The channel order follows the JAX package's: it reads BGR with cv2 and
reverses it, and writes the reverse, so the file's R, G and B hold (u, v,
valid). All readers return float32 numpy arrays, channel-last.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

TAG_CHAR = np.array([202021.25], np.float32)  # `frame_utils.py:16`
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_image(path: str) -> np.ndarray:
    """RGB image -> [H, W, 3] float32 in [0, 255] (`utils.py:17-24`)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)


def read_gray8(path: str) -> np.ndarray:
    """8-bit gray image (an RGB file through Pillow's luma) -> [H, W]
    float32 in [0, 255]."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode != "L":
            im = im.convert("L")
        return np.asarray(im, np.float32)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32 (`frame_utils.py:20-42`)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != TAG_CHAR[0]:
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """[H, W, 2] float32 -> Middlebury .flo (`frame_utils.py:45-65`)."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flo takes [H, W, 2] flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        TAG_CHAR.tofile(f)
        np.asarray([w], np.int32).tofile(f)
        np.asarray([h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """PFM -> ([H, W] or [H, W, 3] float32, scale); `frame_utils.py:67-99`."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"malformed PFM header: {path}")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    # PFM stores rows bottom-to-top
    return np.flipud(data.reshape(shape)).astype(np.float32), scale


def _unfilter_avg_paeth(lines: np.ndarray, kinds: np.ndarray,
                        prior: np.ndarray, bpp: int) -> np.ndarray:
    """Consecutive rows filtered with Average (3: ``x + floor((left + up) /
    2)``) or Paeth (4: ``x`` plus whichever of left, up and upper-left is
    nearest to ``left + up - upper_left``, ties in that order), mod 256.

    Each pixel needs its left neighbour decoded first, so a row is a loop
    over its pixels, vectorised over a pixel's bytes. The rows of the run
    step together along anti-diagonals (pixel j of row r at step r + j),
    since a pixel needs only its left, upper and upper-left neighbours: a
    run of k rows of W pixels takes k + W - 1 steps, not k * W."""
    k, w = lines.shape[0], lines.shape[1] // bpp
    x = lines.astype(np.int16).reshape(k, w, bpp)
    out = np.zeros((k + 1, w + 1, bpp), np.int16)   # a zero column, and
    out[0, 1:] = prior.reshape(w, bpp)              # the row above the run
    paeth_row = (kinds == 4)[:, None]
    for d in range(k + w - 1):
        r = np.arange(max(0, d - w + 1), min(k, d + 1))
        j = d - r
        a, b, c = out[r + 1, j], out[r, j + 1], out[r, j]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(paeth_row[r], paeth, (a + b) >> 1)
        out[r + 1, j + 1] = (x[r, j] + pred) & 255
    return out[1:, 1:].reshape(k, -1).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8- or 16-bit gray or RGB PNG -> ``[H, W]`` or
    ``[H, W, 3]`` (the file's channel order) uint8 or uint16. Raises on
    any other kind (palette, alpha, interlaced, other depths)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, color, compression, filtering, interlace = header
    if interlace:
        raise ValueError(f"interlaced PNG is not supported: {path}")
    if depth not in (8, 16) or color not in (0, 2) or compression \
            or filtering:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color} is "
                         f"not supported (8/16-bit gray or RGB): {path}")
    channels = 1 if color == 0 else 3
    bpp = channels * depth // 8
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data of {rows.size} bytes, want "
                         f"{h * (stride + 1)}: {path}")
    rows = rows.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {kinds.max()} in {path}")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    r = 0
    while r < h:
        kind, line = kinds[r], rows[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:          # Sub: a running sum per byte of a pixel
            out[r] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:          # Up
            out[r] = line + prior
        else:                    # a run of Average and Paeth rows
            end = r + 1
            while end < h and kinds[end] >= 3:
                end += 1
            out[r:end] = _unfilter_avg_paeth(rows[r:end, 1:], kinds[r:end],
                                             prior, bpp)
            r = end - 1
        prior = out[r]
        r += 1
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png16(path: str, img: np.ndarray) -> None:
    """``[H, W, 3]`` uint16 -> a 16-bit big-endian RGB PNG (``[H, W]`` ->
    16-bit gray), row filter 0, the channels in the file's order,
    compressed at zlib level 1 (cv2's default for PNG: the flows' low
    bytes barely compress, and level 6 takes several times longer for a
    few percent)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3) \
            or img.dtype != np.uint16:
        raise ValueError(f"write_png16 takes [H, W, 3] or [H, W] uint16, "
                         f"got {img.shape} {img.dtype}")
    h, w, channels = img.shape
    rows = np.zeros((h, 1 + 2 * channels * w), np.uint8)
    rows[:, 1:] = img.astype(">u2").view(np.uint8).reshape(
        h, 2 * channels * w)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(
                    ">IIBBBBB", w, h, 16, 2 if channels == 3 else 0, 0, 0,
                    0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + _png_chunk(b"IEND", b""))


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG -> (flow [H, W, 2], valid [H, W]), float32.

    Decodes ``(png - 2^15) / 64`` from the file's R and G, valid from B
    (`frame_utils.py:102-107`); a gray file counts as three equal
    channels, as cv2's colour read makes it."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    raw = read_png(path)
    if raw.ndim == 2:
        raw = np.repeat(raw[..., None], 3, axis=2)
    raw = raw.astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> None:
    """(flow, valid) -> KITTI 16-bit PNG (`frame_utils.py:110-114`):
    ``flow * 64 + 2^15`` clipped to [0, 65535] in f64; valid None writes
    ones."""
    h, w = flow.shape[:2]
    out = np.ones((h, w, 3), np.uint16)
    out[:, :, :2] = np.clip(
        flow.astype(np.float64) * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
    if valid is not None:
        out[:, :, 2] = valid.astype(np.uint16)
    write_png16(path, out)


def read_disp_kitti(path: str) -> np.ndarray:
    """KITTI 16-bit disparity PNG -> [H, W] float32 (png / 256), through
    Pillow's 16-bit gray mode."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im)
    return arr.astype(np.float32) / 256.0


def read_gen(path: str) -> np.ndarray:
    """Extension dispatch (`frame_utils.py:117-131`)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        flow = read_pfm(path)[0]
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported extension: {path}")
