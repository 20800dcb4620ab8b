"""Animated GIF89a files from uint8 frames, in numpy and the standard
library (the card's machine has no PIL).

The image data is LZW-coded without compression: every pixel is a literal
9-bit code, and a clear code comes before the decoder's table would reach
512 entries, so the code width never changes; a file is about 9/8 of the
raw frames. Grey frames get a 256-level grey palette and are exact; RGB
frames are quantised to a 3-3-2 bit palette (8 red, 8 green and 4 blue
levels).
"""

import struct

import numpy as np

CLEAR, END = 256, 257
# literals between clear codes: the decoder adds one table entry a code
# after the first, from 258; 250 keeps it well below 512
RUN = 250


def _palette(channels):
    if channels == 1:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    i = np.arange(256)
    levels = lambda v, n: (v * 255 // (n - 1)).astype(np.uint8)  # noqa: E731
    return np.stack([levels(i >> 5, 8), levels((i >> 2) & 7, 8),
                     levels(i & 3, 4)], axis=1)


def _indices(frame):
    """(H, W) palette indices of an (H, W, C) uint8 frame."""
    if frame.shape[-1] == 1:
        return frame[..., 0]
    r, g, b = (frame[..., k].astype(np.int32) for k in range(3))
    return (((r * 7 + 127) // 255) << 5 | ((g * 7 + 127) // 255) << 2
            | ((b * 3 + 127) // 255)).astype(np.uint8)


def _lzw(indices):
    """The frame's LZW data: code size byte, sub-blocks, terminator."""
    pix = indices.reshape(-1).astype(np.int64)
    n_runs = -(-pix.size // RUN)
    body = np.full(n_runs * RUN, -1, dtype=np.int64)
    body[:pix.size] = pix
    codes = np.concatenate([np.full((n_runs, 1), CLEAR),
                            body.reshape(n_runs, RUN)], axis=1).reshape(-1)
    codes = np.concatenate([codes[codes >= 0], [END]])
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def gif_bytes(frames, fps=4.0):
    """An animated, looping GIF of frames (T, H, W, C) uint8, C 1 or 3."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 \
            or frames.shape[-1] not in (1, 3):
        raise ValueError(f"gif_bytes: needs uint8 (T, H, W, 1 or 3), got "
                         f"{frames.dtype} {frames.shape}")
    _, h, w, c = frames.shape
    delay = max(1, int(round(100 / fps)))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           _palette(c).tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in frames:
        out += [struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0),
                struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0),
                _lzw(_indices(frame))]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path, frames, fps=4.0):
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, fps))
