"""Moving MNIST training videos, generated on the fly (counterpart of the
training folds of srvp_tpu/data/mmnist.py; the test fold is
data/mmnist_test.py).

Digits move linearly in continuous time; when a step crosses a frame border
the exact intersection is solved retroactively, the rest of the step is
travelled with the post-bounce velocity, and in stochastic mode a new random
speed is drawn at each bounce. Random draws follow the JAX package's order
exactly, so the same RandomState gives the same video; whole batches come
from the native generator (data/native.py), bit-identical to these items.
Digit images come from the MNIST IDX archive under data_dir, or, where it
is absent and `allow_synthetic` is set, from procedural glyphs.
"""

import gzip
import os
import struct

import numpy as np

from srvp_tpu_torch.data import native
from srvp_tpu_torch.data.base import VideoDataset

EPS = 1e-8


def _find_idx(data_dir, name):
    candidates = [
        os.path.join(data_dir, name),
        os.path.join(data_dir, name + ".gz"),
        os.path.join(data_dir, "MNIST", "raw", name),
        os.path.join(data_dir, "MNIST", "raw", name + ".gz"),
    ]
    return next((p for p in candidates if os.path.exists(p)), None), candidates


def load_mnist_images(data_dir, train=True, missing_ok=False):
    """Reads MNIST IDX image files from common layouts under data_dir."""
    name = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    path, candidates = _find_idx(data_dir, name)
    if path is None:
        if missing_ok:
            return None
        raise FileNotFoundError(
            f"MNIST IDX images not found under {data_dir} "
            f"(tried {candidates})")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad IDX magic in {path}"
        buf = f.read(n * rows * cols)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)
    return [arr[i] for i in range(n)]


def load_mnist_labels(data_dir, train=True):
    """Reads MNIST IDX label files (srvp_tpu/data/mmnist.py:56)."""
    name = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    path, candidates = _find_idx(data_dir, name)
    if path is None:
        raise FileNotFoundError(
            f"MNIST IDX labels not found under {data_dir} "
            f"(tried {candidates})")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX magic {magic} in {path}")
        buf = f.read(n)
    return np.frombuffer(buf, dtype=np.uint8)


def synthetic_digits(n, rng, size=28):
    """Procedural digit-like glyphs for benchmarks/smoke tests when the real
    MNIST archive is unavailable (zero-egress environments).

    MNIST-like statistics: 2-4 thick strokes (random-walk polylines) with
    soft edges, ~100-200 lit pixels, peak intensity near 255.
    """
    yy, xx = np.mgrid[0:size, 0:size]
    digits = []
    for _ in range(n):
        img = np.zeros((size, size), dtype=np.float32)
        n_strokes = rng.randint(2, 5)
        x, y = rng.uniform(6, size - 6, size=2)
        for _ in range(n_strokes):
            angle = rng.uniform(0, 2 * np.pi)
            length = rng.uniform(6, 14)
            x2 = np.clip(x + length * np.cos(angle), 3, size - 3)
            y2 = np.clip(y + length * np.sin(angle), 3, size - 3)
            # rasterize a thick segment as distance-to-segment falloff
            for t in np.linspace(0, 1, 24):
                cx, cy = x + t * (x2 - x), y + t * (y2 - y)
                d2 = (xx - cx) ** 2 + (yy - cy) ** 2
                img = np.maximum(img, 255.0 * np.exp(-d2 / 2.6))
            x, y = x2, y2
        digits.append(np.clip(img, 0, 255).astype(np.uint8))
    return digits


class MovingMNIST(VideoDataset):
    def __init__(self, data, nx, seq_len, max_speed, deterministic,
                 num_digits, train):
        self.data = data
        self.frame_size = nx
        self.seq_len = seq_len
        self.max_speed = max_speed
        self.deterministic = deterministic
        self.num_digits = num_digits
        self.train = train
        self._pack = None

    def change_seq_len(self, seq_len):
        self.seq_len = seq_len

    def _filter(self, data):
        return MovingMNIST(data, self.frame_size, self.seq_len, self.max_speed,
                           self.deterministic, self.num_digits, self.train)

    def __len__(self):
        # Training samples are generated on demand; 500000 is the reference's
        # epoch-size sentinel (mmnist.py:97-104).
        return 500000 if self.train else len(self.data)

    # -- physics ------------------------------------------------------------

    def _first_intersection(self, a, b, sx, sy, flags, x_max, y_max):
        """Returns refined edge flags and the collision point for a moving
        digit whose (pre-resolution) position is out of frame."""
        left, right, upper, bottom = flags
        cx = cy = None
        if left:
            y_int = a * 0.0 + b
            left = -EPS <= y_int <= y_max + EPS
            if left:
                cx, cy = 0.0, y_int
        if right:
            y_int = a * x_max + b
            right = -EPS <= y_int <= y_max + EPS
            if right:
                cx, cy = x_max, y_int
        if upper:
            x_int = (0.0 - b) / a
            upper = -EPS <= x_int <= x_max + EPS
            if upper:
                cx, cy = x_int, 0.0
        if bottom:
            x_int = (y_max - b) / a
            bottom = -EPS <= x_int <= x_max + EPS
            if bottom:
                cx, cy = x_int, y_max
        return (left, right, upper, bottom), cx, cy

    def _bounce(self, rng, sx, sy, dx, dy, x_max, y_max):
        """Resolves any border crossings for one timestep of motion."""
        def edges(sx, sy):
            return (sx < -EPS, sx > x_max + EPS, sy < -EPS, sy > y_max + EPS)

        left, right, upper, bottom = edges(sx, sy)
        while left or right or upper or bottom:
            if dx == 0:
                cx, cy = (sx, 0.0) if upper else (sx, y_max)
            elif dy == 0:
                cx, cy = (0.0, sy) if left else (x_max, sy)
            else:
                a = dy / dx
                b = sy - a * sx
                flags = (left, right, upper, bottom)
                flags, cx, cy = self._first_intersection(
                    a, b, sx, sy, flags, x_max, y_max)
                left, right, upper, bottom = flags
            p = (sx - cx) / dx if dx != 0 else (sy - cy) / dy
            if not self.deterministic:
                dx = rng.randint(-self.max_speed, self.max_speed + 1)
                dy = rng.randint(-self.max_speed, self.max_speed + 1)
            if left:
                dx = abs(dx)
            if right:
                dx = -abs(dx)
            if upper:
                dy = abs(dy)
            if bottom:
                dy = -abs(dy)
            sx = cx + dx * p
            sy = cy + dy * p
            left, right, upper, bottom = edges(sx, sy)
        return sx, sy, dx, dy

    def _compute_trajectory(self, rng, nx, ny, init_cond=None):
        """Returns seq_len (round(sx), round(sy), dx, dy) tuples."""
        x_max = self.frame_size - nx
        y_max = self.frame_size - ny
        if init_cond is None:
            sx = rng.randint(0, x_max + 1)
            sy = rng.randint(0, y_max + 1)
            dx = rng.randint(-self.max_speed, self.max_speed + 1)
            dy = rng.randint(-self.max_speed, self.max_speed + 1)
        else:
            sx, sy, dx, dy = init_cond
        traj = []
        for _ in range(self.seq_len):
            sx, sy, dx, dy = self._bounce(rng, sx, sy, dx, dy, x_max, y_max)
            traj.append((int(round(sx)), int(round(sy)), dx, dy))
            sx += dx
            sy += dy
        return traj

    # -- item access ---------------------------------------------------------

    def get_item(self, index, rng=None):
        if not self.train:
            return self.data[index]
        assert rng is not None, "training items need an explicit RandomState"
        x = np.zeros((self.seq_len, self.frame_size, self.frame_size),
                     np.float32)
        for _ in range(self.num_digits):
            img = self.data[rng.randint(len(self.data))]
            traj = self._compute_trajectory(rng, *img.shape)
            for t in range(self.seq_len):
                sx, sy, _, _ = traj[t]
                x[t, sx:sx + img.shape[0], sy:sy + img.shape[1]] += img
        return np.minimum(x, 255).astype(np.uint8)

    def get_item_parts(self, index, rng):
        """Returns (digits (D, h, w) uint8, pos (D, T, 2) int32) — the same
        draws as get_item WITHOUT compositing; frames are composited on
        device (data/device_compose.py). Requires uniformly-shaped
        digit images (MNIST: 28x28)."""
        assert self.train
        digits = np.zeros((self.num_digits,) + self.data[0].shape, np.uint8)
        pos = np.zeros((self.num_digits, self.seq_len, 2), np.int32)
        for n in range(self.num_digits):
            img = self.data[rng.randint(len(self.data))]
            traj = self._compute_trajectory(rng, *img.shape)
            digits[n] = img
            pos[n] = [(sx, sy) for sx, sy, _, _ in traj]
        return digits, pos

    def _digit_pack(self):
        if self._pack is None:
            self._pack = native.DigitPack(self.data, self.frame_size)
        return self._pack

    def get_batch_seeded(self, indices, seeds, n_threads=4):
        """The native generator's batch of videos, (B, T, H, W) uint8, video
        i bit-equal to get_item(indices[i], RandomState(seeds[i])) (a
        training video does not depend on its index)."""
        assert self.train
        return native.mmnist_generate_batch(
            self._digit_pack(), self.frame_size, self.seq_len,
            self.max_speed, self.deterministic, self.num_digits, seeds,
            n_threads)

    def get_parts_batch_seeded(self, indices, seeds, n_threads=4):
        """The native generator's parts batch, {"digits": (B, D, h, w)
        uint8, "pos": (B, D, T, 2) int32}, the draws of get_item_parts with
        RandomState(seeds[i]) (counterpart of
        srvp_tpu/data/mmnist.py:244)."""
        assert self.train
        digits, pos = native.mmnist_parts_batch(
            self._digit_pack(), self.frame_size, self.seq_len,
            self.max_speed, self.deterministic, self.num_digits, seeds,
            n_threads)
        return {"digits": digits, "pos": pos}

    @classmethod
    def make_dataset(cls, data_dir, nx, seq_len, max_speed, deterministic,
                     num_digits, allow_synthetic=False):
        """The training dataset (train and val folds via get_fold)."""
        data = load_mnist_images(data_dir, train=True,
                                 missing_ok=allow_synthetic)
        if data is None:
            data = synthetic_digits(1000, np.random.RandomState(0))
        return cls(data, nx, seq_len, max_speed, deterministic, num_digits,
                   True)
