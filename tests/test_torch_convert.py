"""The port's TFRecord reader (srvp_tpu_torch/data/tfrecord.py) and BAIR
converter (srvp_tpu_torch/data/convert.py) against preprocessing/bair/
{tfrecord_reader,convert}.py on the CPU: records written by the test-side
encoder of tests/test_preprocessing.py (and by the port's own writer) parse
alike, every field type included; on the same softmotion30_44k files both
converters write the same paths, every port PNG decodes through data/png.py
and through PIL to the record's raw bytes, the port's files total at most
1.10x PIL's, and a second run onto the tree raises."""

import io
import os
import shutil
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from preprocessing.bair import convert as jax_convert
from preprocessing.bair.tfrecord_reader import parse_example as jax_parse
from preprocessing.bair.tfrecord_reader import (
    tfrecord_iterator as jax_records)
from srvp_tpu_torch.data import bair, convert, png, tfrecord
from srvp_tpu_torch.data.synthetic import bench_video, synthetic_rgb_videos
from tests.test_preprocessing import _encode_example, _write_tfrecord

# PNG bytes of the port's converter over PIL's on the same frames
MAX_BYTES_OVER_PIL = 1.10


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def unpacked_example():
    """An Example whose FloatList and Int64List are not packed, and whose
    map entries carry a field the parsers skip."""
    def ld(field, payload):
        return tfrecord._field(field, payload)
    floats = b"".join(b"\x0d" + struct.pack("<f", v) for v in (0.5, -3.25))
    ints = b"".join(b"\x08" + tfrecord._varint(v) for v in (5, -7, 1 << 40))
    entries = (ld(1, ld(1, b"f") + ld(2, ld(2, floats)))
               + ld(1, ld(1, b"i") + ld(2, ld(3, ints)))
               + ld(1, ld(1, b"b") + ld(2, ld(1, ld(1, b"") + ld(1, b"q")))
                    + b"\x18\x01"))
    return ld(1, entries)


def test_crc32c_known_value():
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.crc32c(b"") == 0


def test_reader_matches_jax(tmp_path):
    examples = [
        _encode_example({"0/image_aux1/encoded": [b"\x01\x02\x03" * 4096],
                         "scores": [1.5, -2.0], "ids": [7, 300, -1]}),
        _encode_example({"0/image_aux1/encoded": [b"xyz", b""]}),
        unpacked_example(),
        tfrecord.encode_example({"a": [b"\x00" * 9], "n": [-(1 << 62), 3],
                                 "x": [0.25, 1e-3]}),
    ]
    ref_path, our_path = tmp_path / "ref.tfrecord", tmp_path / "our.tfrecord"
    _write_tfrecord(ref_path, examples)
    tfrecord.write_tfrecord(our_path, examples)
    # a truncated last record is left out by both
    with open(ref_path, "ab") as f:
        f.write(struct.pack("<Q", 100) + b"\x00" * 10)
    for path in (ref_path, our_path):
        ours = list(tfrecord.tfrecord_iterator(path))
        assert ours == list(jax_records(str(path))) == examples
        for payload in ours:
            assert tfrecord.parse_example(payload) == jax_parse(payload)
    parsed = tfrecord.parse_example(examples[0])
    assert parsed["ids"] == [7, 300, -1] and parsed["scores"] == [1.5, -2.0]
    assert tfrecord.parse_example(examples[2]) == {
        "f": [0.5, -3.25], "i": [5, -7, 1 << 40], "b": [b"", b"q"]}
    assert tfrecord.parse_example(examples[3])["n"] == [-(1 << 62), 3]
    # the port's writer frames each record with its masked CRC-32C
    data = our_path.read_bytes()
    n = len(examples[0])
    assert struct.unpack("<I", data[8:12])[0] == tfrecord.masked_crc32c(
        data[:8])
    assert struct.unpack("<I", data[12 + n:16 + n])[0] == \
        tfrecord.masked_crc32c(examples[0])


def bair_kind(i):
    return "noise_amp 14" if i % 2 == 0 else "disc"


def bair_video(i):
    """30 RGB frames: natural video's noise on a moving gradient (even i,
    the frames of data/synthetic.write_bair_download), or a flat disc on a
    gradient (odd i)."""
    if bair_kind(i) == "noise_amp 14":
        return bench_video(i, 30, rgb=True, noise_amp=14)
    return synthetic_rgb_videos(1, 30, 64, np.random.RandomState(i))[0]


@pytest.fixture(scope="module")
def download(tmp_path_factory):
    """softmotion30_44k/{train,test}: 2 train files of 1 record, 1 test
    file of 2 (file names without and with an extension). Returns (root,
    {(fold, file stem, k): (video, its kind)})."""
    root = tmp_path_factory.mktemp("bair")
    files = {("train", "traj_0_to_255.tfrecords"): [0],
             ("train", "traj_256_to_511.tfrecords"): [1],
             ("test", "traj_0_to_255"): [2, 3]}
    videos = {}
    for (fold, name), ids in files.items():
        (root / "softmotion30_44k" / fold).mkdir(parents=True, exist_ok=True)
        payloads = []
        for k, i in enumerate(ids, start=1):
            video = bair_video(i)
            videos[fold, os.path.splitext(name)[0], k] = video, bair_kind(i)
            payloads.append(_encode_example(
                {f"{t}/image_aux1/encoded": [video[t].tobytes()]
                 for t in range(30)} | {"0/action": [0.5, -0.5]}))
        _write_tfrecord(root / "softmotion30_44k" / fold / name, payloads)
    return root, videos


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root / "processed_data")
                  for f in fs)


def test_converter_matches_jax(download, tmp_path, capsys):
    src, videos = download
    ours, ref = tmp_path / "port", tmp_path / "jax"
    for d in (ours, ref):
        shutil.copytree(src, d)
    capsys.readouterr()
    assert convert.main(["bair", "--data_dir", str(ours)]) == {"train": 2,
                                                               "test": 2}
    our_out = capsys.readouterr().out
    for fold in ("train", "test"):
        jax_convert.convert_data(str(ref), fold)
    ref_out = capsys.readouterr().out
    assert [ln.replace(str(ours), "") for ln in our_out.splitlines()
            if ln.endswith(")")] == \
        [ln.replace(str(ref), "") for ln in ref_out.splitlines()]
    paths = tree(ours)
    assert paths == tree(ref) and len(paths) == 4 * 30
    sizes = {}      # {kind of video: [frames, port's bytes, PIL's bytes]}
    for (fold, stem, k), (video, kind) in videos.items():
        size = sizes.setdefault(kind, [0, 0, 0])
        vdir = f"processed_data/{fold}/{stem}/{k:03d}"
        frames = [ours / vdir / f"{t:03d}.png" for t in range(30)]
        np.testing.assert_array_equal(
            png.decode_png_batch([str(p) for p in frames], 64, 64, 3), video)
        for t, p in enumerate(frames):
            np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                          video[t])
            buf = io.BytesIO()
            Image.fromarray(video[t]).save(buf, "PNG")
            size[0] += 1
            size[1] += p.stat().st_size
            size[2] += len(buf.getvalue())
            assert (ref / vdir / f"{t:03d}.png").stat().st_size == \
                len(buf.getvalue())
    for kind, (n, ours_b, pil_b) in sizes.items():
        print(f"BAIR frames, {kind}: {ours_b / n:.1f} bytes a frame by the "
              f"port's converter, {pil_b / n:.1f} by PIL "
              f"({ours_b / pil_b:.4f}x)")
    our_bytes, pil_bytes = (sum(v[i] for v in sizes.values()) for i in (1, 2))
    assert our_bytes <= MAX_BYTES_OVER_PIL * pil_bytes, (our_bytes,
                                                         pil_bytes)
    # the port's BAIR test fold reads the tree in the records' order
    fold = bair.BAIR.make_dataset(str(ours), 30, train=False)
    np.testing.assert_array_equal(fold.get_item(1),
                                  videos["test", "traj_0_to_255", 2][0])
    # a second run onto the tree raises, as the JAX converter does
    with pytest.raises(FileExistsError):
        convert.main(["bair", "--data_dir", str(ours)])


def test_converter_refuses_bad_downloads(tmp_path):
    with pytest.raises(RuntimeError, match="No data files found"):
        convert.convert_bair(str(tmp_path), "test")
    (tmp_path / "softmotion30_44k" / "test").mkdir(parents=True)
    _write_tfrecord(tmp_path / "softmotion30_44k" / "test" / "f",
                    [_encode_example({f"{t}/image_aux1/encoded": [b"\x00"]
                                      for t in range(30)})])
    with pytest.raises(ValueError, match="frame 0 holds 1 bytes"):
        convert.convert_bair(str(tmp_path), "test")


def test_adaptive_png_near_pil(tmp_path):
    """The converter's mode: each row under the filter of least signed
    absolute sum (all five; PIL leaves Average out), the frame decoded back,
    the file within MAX_BYTES_OVER_PIL of PIL's; the forced filters of the
    synthetic trees stay as they were."""
    frame = bair_video(0)[3]
    path = tmp_path / "f.png"
    path.write_bytes(png.png_bytes(frame, png.ADAPTIVE))
    _, _, _, lines = png.read_png(path)
    np.testing.assert_array_equal(
        png.defilter(lines[None], 3)[0].reshape(64, 64, 3), frame)
    every = png.png_filtered_rows(frame.reshape(64, 192), 3).astype(np.int32)
    cost = np.minimum(every, 256 - every).sum(axis=2)
    np.testing.assert_array_equal(lines[:, 0], cost.argmin(axis=0))
    assert len(set(lines[:, 0])) > 1
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    assert path.stat().st_size <= MAX_BYTES_OVER_PIL * len(buf.getvalue())
    forced = tmp_path / "forced.png"
    forced.write_bytes(png.png_bytes(frame, [0, 1, 2, 3, 4]))
    assert list(png.read_png(forced)[3][:5, 0]) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="adaptive"):
        png.png_bytes(frame, "best")
