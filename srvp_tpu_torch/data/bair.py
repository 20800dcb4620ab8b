"""BAIR robot pushing videos, 30 RGB frames of 64 x 64 each (counterpart of
srvp_tpu/data/bair.py).

A fold is the packed tree `{data_dir}/packed_data/{fold}/{dir}/{video}.npy`,
one raw uint8 (30, 64, 64, 3) array per video (data/pack.py),
when its `COMPLETE.json` marker names the number of videos found;
otherwise the PNG tree `{data_dir}/processed_data/{fold}/{dir}/{video}/
*.png`, whose frames the native PNG decoder reads (data/native.py). Both
walk their directories in the same sorted order, so the videos, and the
seed-42 train/validation folds, are the same on either;
`prefer_packed=False` reads the PNG tree even where a complete packed tree
stands beside it (srvp_tpu/data/bair.py:100-103). An item is a video
of the fold's order; a training window starts at random (drawn from the
item's RandomState as in the JAX package), a test one at frame 0. A batch
is decoded in one native call (`get_batch_seeded`, and
`get_batch_timemajor_u8` straight into the collated layout), or copied from
the memory-mapped packed videos.
"""

import os
from os.path import join

import numpy as np

from srvp_tpu_torch.data import native
from srvp_tpu_torch.data.base import VideoDataset
from srvp_tpu_torch.data.kth import packed_tree_complete

VIDEO_LEN, NX, NC = 30, 64, 3


class BAIR(VideoDataset):
    def __init__(self, data, seq_len, train, packed=False):
        if seq_len > VIDEO_LEN:
            raise ValueError(f"BAIR videos hold {VIDEO_LEN} frames, not "
                             f"{seq_len}")
        self.data = data    # [.npy path] packed, or [frame paths] a video
        self.nx, self.nc = NX, NC
        self.seq_len = seq_len
        self.train = train
        self.packed = packed

    def change_seq_len(self, seq_len):
        self.seq_len = seq_len

    def _filter(self, data):
        return BAIR(data, self.seq_len, self.train, self.packed)

    def _window_start(self, rng):
        return rng.randint(VIDEO_LEN - self.seq_len + 1) if self.train else 0

    def _window(self, index, rng):
        t0 = self._window_start(rng)
        if self.packed:
            return np.load(self.data[index], mmap_mode="r")[
                t0:t0 + self.seq_len]
        return self.data[index][t0:t0 + self.seq_len]

    def frame_paths(self, index, rng):
        """The frame files of get_item's window of video `index` (PNG
        tree)."""
        return self._window(index, rng)

    def get_item(self, index, rng=None):
        """uint8 (T, 64, 64, 3): video `index` from a random start (train)
        or from frame 0."""
        w = self._window(index, rng)
        if self.packed:
            return np.array(w)
        return native.decode_png_batch(w, NX, NX, NC, n_threads=1)

    def _windows(self, indices, seeds):
        """The windows get_item gives each index with RandomState(seed):
        one generator seeded again per item, the same draws as a new one
        per item at a fiftieth of the host time."""
        rng, windows = np.random.RandomState(), []
        for index, seed in zip(indices, seeds):
            rng.seed(seed)
            windows.append(self._window(index, rng))
        return windows

    def get_batch_seeded(self, indices, seeds, n_threads=4):
        """uint8 (B, T, 64, 64, 3): get_item of each index with
        RandomState(seed)."""
        windows = self._windows(indices, seeds)
        if self.packed:
            return np.stack(windows)
        return native.decode_png_batch(
            [p for w in windows for p in w], NX, NX, NC, n_threads).reshape(
            len(indices), self.seq_len, NX, NX, NC)

    def get_batch_timemajor_u8(self, indices, seeds, n_threads=4):
        """The same windows as the collated uint8 batch (T, B, 64, 64, 3),
        decoded or copied straight into it."""
        windows = self._windows(indices, seeds)
        if not self.packed:
            return native.decode_png_timemajor(
                [p for w in windows for p in w], len(indices), self.seq_len,
                NX, NX, NC, n_threads)
        out = np.empty((self.seq_len, len(indices), NX, NX, NC), np.uint8)
        for b, w in enumerate(windows):
            out[:, b] = w
        return out

    @classmethod
    def make_dataset(cls, data_dir, seq_len, train, prefer_packed=True):
        fold = "train" if train else "test"
        packed_root = join(data_dir, "packed_data", fold)
        if prefer_packed and os.path.isdir(packed_root):
            data = [join(packed_root, d, f)
                    for d in sorted(os.listdir(packed_root))
                    if os.path.isdir(join(packed_root, d))
                    for f in sorted(os.listdir(join(packed_root, d)),
                                    key=lambda f: os.path.splitext(f)[0])
                    if f.endswith(".npy")]
            if packed_tree_complete(packed_root, len(data)):
                return cls(data, seq_len, train, packed=True)
        root = join(data_dir, "processed_data", fold)
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"no BAIR PNG tree at {root}, and no complete packed tree at "
                f"{packed_root} (python -m srvp_tpu_torch.data.pack "
                "--dataset bair writes it with its COMPLETE.json)")
        data = [sorted(join(root, d1, d2, img)
                       for img in os.listdir(join(root, d1, d2))
                       if os.path.splitext(img)[1] == ".png")
                for d1 in sorted(os.listdir(root))
                for d2 in sorted(os.listdir(join(root, d1)))]
        if not any(data):
            raise ValueError(f"the BAIR PNG tree at {root} holds no frames")
        return cls(data, seq_len, train)
