"""PNG frames in numpy and Python's zlib: the plain version of the port's
native decoder (srvp_tpu_torch/csrc/png_decode.cpp, bound in data/native.py),
with the semantics of srvp_tpu/native/loader.py's decode_png_batch.

It reads 8-bit, non-interlaced gray or RGB files: the chunks are parsed, the
IDAT stream inflated, and the five row filters (None, Sub, Up, Average,
Paeth) undone. With `channels == 1` a colour file gives its red channel, not
a luma (the KTH loaders keep `frame[:, :, 0]`); with `channels == 3` the
file must be RGB. Any other file (palette, alpha, 16-bit, interlaced, not a
PNG, corrupt, of another size) raises PNGError naming it. Chunk CRCs are not
checked, as in the native decoders.

The row filters are undone for a whole batch of frames at once: rows are
sequential, but each row is one numpy operation over every frame that uses
the same filter on it, and only Average and Paeth walk the row pixel by
pixel (in Python ints where a row has few frames, SCALAR_WIDTH). The tests
hold this module against PIL, and chip_smoke holds the native decoder
against it.

The writer (`png_bytes`, `write_png_video`) makes 8-bit gray or RGB files
with the standard library's zlib, for synthetic frame trees on a machine
without an image library: row y of frame t goes under row filter (y + t) % 5
of the five, so that each frame holds every filter and the first row, which
has no row above, meets each of them over five frames.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOUR_TYPES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha",
                6: "RGBA"}


# rows of k frames of bpp bytes a pixel with k * bpp at most this walk
# Average and Paeth in Python ints (_walk_row), wider ones in numpy
SCALAR_WIDTH = 40


class PNGError(ValueError):
    """A file that the decoders do not read."""


def read_png(path):
    """(height, width, channels, scanlines): the file's inflated scanlines,
    uint8 (height, 1 + width * channels), each row's filter type first."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file")
    off, header, idat = 8, None, []
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        if off + 12 + length > len(data):
            raise PNGError(f"{path}: truncated {kind!r} chunk")
        body = data[off + 8:off + 8 + length]
        if kind == b"IHDR":
            if length != 13:
                raise PNGError(f"{path}: IHDR of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        off += 12 + length
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in (0, 2) or interlace:
        raise PNGError(
            f"{path}: unsupported PNG ({depth}-bit "
            f"{COLOUR_TYPES.get(colour, f'colour type {colour}')}"
            f"{', interlaced' if interlace else ''}); only 8-bit "
            "non-interlaced gray or RGB is read")
    channels = 1 if colour == 0 else 3
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: corrupt image data ({e})") from e
    if len(raw) != height * (1 + width * channels):
        raise PNGError(f"{path}: {len(raw)} bytes of image data for "
                       f"{height} x {width} x {channels}")
    return height, width, channels, np.frombuffer(raw, np.uint8).reshape(
        height, 1 + width * channels)


def _paeth(left, up, up_left):
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    return np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, up_left))


def _walk_row(kind, src, up, bpp):
    """Average (3) or Paeth (4) undone on k rows in Python ints: for few
    frames, cheaper than numpy's calls a pixel."""
    out = []
    for s, u in zip(src.tolist(), up.tolist()):
        row = [0] * len(s)
        for x in range(len(s)):
            a = row[x - bpp] if x >= bpp else 0
            if kind == 3:
                pred = (a + u[x]) >> 1
            else:
                b, c = u[x], (u[x - bpp] if x >= bpp else 0)
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[x] = (s[x] + pred) & 255
        out.append(row)
    return np.array(out, np.int16).reshape(src.shape)


def _defilter_row(kind, src, up, bpp):
    """One row of k frames, (k, width * bpp) int16, undone from filter
    `kind` given the row above (zeros on the first row)."""
    if kind == 0:
        return src
    if kind == 1:   # Sub: a running sum along each channel
        k, n = src.shape
        return np.cumsum(src.reshape(k, n // bpp, bpp), axis=1,
                         dtype=np.uint8).reshape(k, n).astype(np.int16)
    if kind == 2:   # Up
        return (src + up) & 255
    if src.shape[0] * bpp <= SCALAR_WIDTH:
        return _walk_row(kind, src, up, bpp)
    out = np.empty_like(src)
    left = np.zeros((src.shape[0], bpp), np.int16)
    up_left = left
    for x in range(0, src.shape[1], bpp):
        above = up[:, x:x + bpp]
        pred = ((left + above) >> 1 if kind == 3
                else _paeth(left, above, up_left))
        left = out[:, x:x + bpp] = (src[:, x:x + bpp] + pred) & 255
        up_left = above
    return out


def defilter(scanlines, bpp, names=None):
    """uint8 (N, height, 1 + width * bpp) filtered scanlines of N frames ->
    uint8 (N, height, width * bpp) pixels. `names` (the files) name a frame
    whose filter type is not one of the five."""
    n, height, _ = scanlines.shape
    kinds = scanlines[:, :, 0]
    bad = np.argwhere(kinds > 4)
    if len(bad):
        i, y = bad[0]
        raise PNGError(f"{names[i] if names else f'frame {i}'}: row {y} "
                       f"has filter type {kinds[i, y]}")
    src = scanlines[:, :, 1:].astype(np.int16)
    out = np.empty(src.shape, np.uint8)
    prev = np.zeros((n, src.shape[2]), np.int16)
    for y in range(height):
        row = np.empty_like(prev)
        for kind in np.unique(kinds[:, y]):
            sel = kinds[:, y] == kind
            row[sel] = _defilter_row(int(kind), src[sel, y], prev[sel], bpp)
        out[:, y] = row
        prev = row
    return out


def decode_png_batch(paths, h, w, channels):
    """uint8 (N, h, w) for channels == 1 (a colour file's red channel) or
    (N, h, w, 3) for channels == 3 (RGB files only): the native
    decode_png_batch's frames."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, not {channels}")
    out = np.empty((len(paths), h, w, channels), np.uint8)
    groups = {}
    for i, path in enumerate(paths):
        height, width, src_c, lines = read_png(path)
        if (height, width) != (h, w):
            raise PNGError(f"{path}: {height} x {width} pixels, expected "
                           f"{h} x {w}")
        if channels == 3 and src_c != 3:
            raise PNGError(f"{path}: a gray file where RGB frames are read")
        groups.setdefault(src_c, []).append((i, lines))
    for src_c, items in groups.items():
        index = [i for i, _ in items]
        pixels = defilter(np.stack([lines for _, lines in items]), src_c,
                          [paths[i] for i in index])
        out[index] = pixels.reshape(len(index), h, w, src_c)[..., :channels]
    return out[..., 0] if channels == 1 else out


def png_filtered_rows(img, bpp):
    """uint8 (H, W * bpp) -> uint8 (5, H, W * bpp): every row under each of
    the five row filters."""
    x = img.astype(np.int16)
    up, left, up_left = (np.zeros_like(x) for _ in range(3))
    up[1:], left[:, bpp:], up_left[1:, bpp:] = x[:-1], x[:, :-bpp], \
        x[:-1, :-bpp]
    return (np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                      x - _paeth(left, up, up_left)]) & 255).astype(np.uint8)


def png_bytes(img, filters):
    """An 8-bit PNG file of uint8 img, (H, W) gray or (H, W, 3) RGB, row y
    under row filter filters[y % len(filters)]."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    kinds = np.array([filters[y % len(filters)] for y in range(h)], np.uint8)
    rows = png_filtered_rows(img.reshape(h, w * bpp), bpp)[kinds,
                                                           np.arange(h)]
    raw = np.concatenate([kinds[:, None], rows], axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         0 if bpp == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png_video(vdir, video, name="{:02d}.png"):
    """Frame t of uint8 video (T, H, W[, 3]) as vdir / name.format(t),
    under the filters (y + t) % 5. Returns the paths."""
    vdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for t, frame in enumerate(video):
        paths.append(vdir / name.format(t))
        paths[-1].write_bytes(png_bytes(frame, [(y + t) % 5
                                                for y in range(5)]))
    return paths
