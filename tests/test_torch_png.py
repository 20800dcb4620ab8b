"""The port's PNG decoders on the CPU: the plain version (data/png.py)
against PIL on the frames scripts/make_synthetic_bair.py writes and on
hand-encoded files that force each of the five row filters (first rows
included) in gray and RGB; the red-channel rule; the native decoder
(srvp_tpu_torch/csrc/png_decode.cpp, data/native.py) against the plain
version in both layouts, its library built apart from the Moving MNIST
generator's; and every file outside 8-bit non-interlaced gray or RGB (a
palette, alpha, 16 bits, interlacing, not a PNG, a corrupt stream, another
size) raising with its name, in both decoders. Frames are bit-equal."""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch

from srvp_tpu.native.loader import decode_png_batch as jax_decode_batch
from srvp_tpu_torch.data import native, png, synthetic

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bair_frames(tmp_path_factory):
    """The PNG frames of scripts/make_synthetic_bair.py (PIL's encoder),
    2 train and 1 test videos of 30 frames."""
    root = tmp_path_factory.mktemp("bair")
    subprocess.run([sys.executable, str(ROOT / "scripts" /
                                        "make_synthetic_bair.py"),
                    "--out", str(root), "--n_train", "2", "--n_test", "1"],
                   check=True, capture_output=True)
    return sorted(str(p) for p in root.rglob("*.png"))


def write(path, data):
    path.write_bytes(data)
    return str(path)


def test_plain_decoder_matches_pil_on_synthetic_bair(bair_frames):
    assert len(bair_frames) == 90
    batch = png.decode_png_batch(bair_frames, 64, 64, 3)
    assert batch.shape == (90, 64, 64, 3) and batch.dtype == np.uint8
    for path, frame in zip(bair_frames, batch):
        np.testing.assert_array_equal(frame, np.asarray(Image.open(path)))


@pytest.mark.parametrize("bpp", [1, 3])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_row_filter_matches_pil(tmp_path, kind, bpp):
    """Every row under one filter, the first (no row above) included, and
    rows whose neighbours wrap around 255."""
    rng = np.random.RandomState(10 * bpp + kind)
    img = rng.randint(0, 256, (17, 23) + ((3,) if bpp == 3 else ()),
                      np.uint8)
    img[5] = 255
    path = write(tmp_path / "f.png", png.png_bytes(img, [kind]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(
        png.decode_png_batch([path], 17, 23, bpp)[0], img)
    got = native.decode_png_batch([path], 17, 23, bpp, n_threads=1)
    np.testing.assert_array_equal(got[0], img)


def test_chip_smoke_videos_decode_alike(tmp_path):
    """The stdlib writer (row y of frame t under filter (y + t) % 5) in
    gray and RGB: the plain decoder, the native one in both layouts and
    the JAX package's native decoder give the frames written, PIL too."""
    video = synthetic.synthetic_rgb_videos(1, 7, 64,
                                           np.random.RandomState(0))[0]
    rgb = png.write_png_video(tmp_path / "rgb", video)
    gray = png.write_png_video(tmp_path / "gray", video[..., 2])
    for paths, frames, c in ((rgb, video, 3), (gray, video[..., 2], 1)):
        paths = [str(p) for p in paths]
        for p, f in zip(paths, frames):
            np.testing.assert_array_equal(np.asarray(Image.open(p)), f)
        plain = png.decode_png_batch(paths, 64, 64, c)
        np.testing.assert_array_equal(plain, frames)
        np.testing.assert_array_equal(
            native.decode_png_batch(paths, 64, 64, c, n_threads=3), plain)
        np.testing.assert_array_equal(jax_decode_batch(paths, 64, 64, c),
                                      plain)


def test_red_channel_rule(tmp_path):
    """channels == 1 on a colour file keeps its red channel (KTH's
    frame[:, :, 0]), not a luma, through every filter."""
    img = np.random.RandomState(2).randint(0, 256, (12, 12, 3), np.uint8)
    path = write(tmp_path / "rgb.png",
                 png.png_bytes(img, [0, 1, 2, 3, 4]))
    want = np.asarray(Image.open(path))[:, :, 0]
    assert not np.array_equal(
        want, np.asarray(Image.open(path).convert("L")))
    np.testing.assert_array_equal(png.decode_png_batch([path], 12, 12, 1)[0],
                                  want)
    np.testing.assert_array_equal(
        native.decode_png_batch([path], 12, 12, 1)[0], want)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_native_matches_plain_in_both_layouts(bair_frames, tmp_path,
                                              n_threads):
    """Mixed gray and RGB files read as gray (the red channel), and RGB
    files read as RGB, into the per-frame and the time-major layouts."""
    gray = [write(tmp_path / f"g{i}.png", png.png_bytes(
        np.asarray(Image.open(p))[..., 1], [i % 5, 4, 3]))
        for i, p in enumerate(bair_frames[:12])]
    mixed = [p for pair in zip(gray, bair_frames[30:42]) for p in pair]
    before = dict(native.decoded)
    for paths, c in ((mixed, 1), (bair_frames, 3)):
        plain = png.decode_png_batch(paths, 64, 64, c)
        np.testing.assert_array_equal(
            native.decode_png_batch(paths, 64, 64, c, n_threads), plain)
        n_videos, seq_len = len(paths) // 6, 6
        tm = native.decode_png_timemajor(paths, n_videos, seq_len, 64, 64,
                                         c, n_threads)
        assert tm.shape == (seq_len, n_videos, 64, 64, c)
        np.testing.assert_array_equal(
            tm, plain.reshape(n_videos, seq_len, 64, 64, c).swapaxes(0, 1))
    assert native.decoded == {"batches": before["batches"] + 4,
                              "frames": before["frames"] + 2 * (24 + 90)}


def png_with(img, colour, depth=8, interlace=0):
    """A file whose header says `colour`, `depth`, `interlace` over img's
    bytes (only the header matters to the decoders)."""
    h, w = img.shape[:2]
    raw = b"".join(b"\0" + row.tobytes() for row in img.reshape(h, -1))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def bad_files(tmp_path):
    """(file, channels asked) that both decoders must reject."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (8, 8, 3), np.uint8)
    pal = tmp_path / "palette.png"
    Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                 colors=16).save(pal)
    rgba = tmp_path / "rgba.png"
    Image.fromarray(np.dstack([img, img[..., :1]])).save(rgba)
    jpeg = tmp_path / "jpeg.png"
    Image.fromarray(img).save(jpeg, format="JPEG")
    good = png.png_bytes(img, [4])
    corrupt = bytearray(good)
    corrupt[60] ^= 0x55
    return [
        (str(pal), 3), (str(rgba), 3), (str(jpeg), 3),
        (write(tmp_path / "deep.png", png_with(img[..., 0], 0, depth=16)), 1),
        (write(tmp_path / "laced.png", png_with(img, 2, interlace=1)), 3),
        (write(tmp_path / "corrupt.png", bytes(corrupt)), 3),
        (write(tmp_path / "cut.png", good[:50]), 3),
        (write(tmp_path / "small.png", png.png_bytes(img[:4], [0])),
         3),
        (write(tmp_path / "gray.png", png.png_bytes(img[..., 0],
                                                           [0])), 3),
        (str(tmp_path / "missing.png"), 3)]


def test_rejected_files_raise_with_their_name(tmp_path):
    good = write(tmp_path / "good.png",
                 png.png_bytes(np.zeros((8, 8, 3), np.uint8), [1]))
    for path, c in bad_files(tmp_path):
        with pytest.raises((ValueError, OSError), match=Path(path).name):
            png.decode_png_batch([good, path], 8, 8, c)
        with pytest.raises(ValueError, match=Path(path).name):
            native.decode_png_batch([good, path, good], 8, 8, c,
                                    n_threads=2)
        with pytest.raises(ValueError, match=Path(path).name):
            native.decode_png_timemajor([good, path], 1, 2, 8, 8, c)


def test_native_libraries_are_built_apart_and_a_failed_build_raises(
        tmp_path):
    """The decoder is a library of its own beside the generator's, keyed
    on its source; g++ failing raises."""
    png_lib = native.build(native.PNG_SOURCE, "png")
    assert png_lib == native.library_path(native.PNG_SOURCE, "png")
    assert png_lib.parent == ROOT / "build" / "native"
    assert png_lib.name.startswith("libsrvp_png_")
    assert png_lib != native.library_path()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(broken, "broken")


@pytest.mark.parametrize("width", [0, 10**6])
def test_plain_row_walks_agree(tmp_path, monkeypatch, width):
    """Average and Paeth rows undone in numpy across the frames (width 0)
    and in Python ints a frame (every width): PIL's frames, gray and RGB,
    on batches of 1 to 40 frames under every filter."""
    monkeypatch.setattr(png, "SCALAR_WIDTH", width)
    video = synthetic.synthetic_rgb_videos(1, 40, 16,
                                           np.random.RandomState(1))[0]
    for frames, c in ((video, 3), (video[..., 1], 1)):
        paths = [str(p) for p in png.write_png_video(tmp_path / str(c),
                                                     frames)]
        for n in (1, 7, 40):
            want = np.stack([np.asarray(Image.open(p)) for p in paths[:n]])
            np.testing.assert_array_equal(
                png.decode_png_batch(paths[:n], 16, 16, c), want)
