"""KTH action videos (counterpart of srvp_tpu/data/kth.py and of the
completion check of srvp_tpu/data/base.py).

Train and validation folds come from the packed tree
`{data_dir}/packed_{nx}/{class}/{video}.npy`, one raw uint8 (T, nx, nx)
array per video (data/pack.py), when its `COMPLETE.json` marker
names the number of videos found; otherwise from the PNG tree
`{data_dir}/processed_{nx}/{class}/{video}/*.png`, each frame decoded by the
native PNG decoder (data/native.py; a colour file gives its red channel).
Both enumerate the videos in the same order, so the seed-42 folds agree;
`prefer_packed=False` reads the PNG tree even where a complete packed tree
stands beside it (srvp_tpu/data/kth.py:121-124).
Persons 21-25 are the test persons and are left out. An item is a random
video (drawn again while it is shorter than the window) and a random
temporal window of it, drawn from the item's RandomState in the JAX
package's order, so the same seeds give the same windows on either tree. A
batch is decoded in one native call (`get_batch_seeded`, and
`get_batch_timemajor_u8` straight into the collated layout), or copied from
the memory-mapped packed videos. The test fold is
`{data_dir}/svg_test_set_{seq_len}.npz`, whose `sequences` are uint8 (N, T,
nx, nx[, 1]).
"""

import json
import os
from os.path import join

import numpy as np

from srvp_tpu_torch.data import native
from srvp_tpu_torch.data.base import VideoDataset

CLASSES = ["boxing", "handclapping", "handwaving", "jogging", "running",
           "walking"]


def packed_tree_complete(packed_root, n_found):
    """True iff `packed_root` holds the pack script's COMPLETE.json marker
    and the marker's video count is the number enumerated. A partial tree
    would shrink the dataset and shift the seed-42 fold split."""
    try:
        with open(join(packed_root, "COMPLETE.json")) as f:
            expected = json.load(f).get("videos")
    except (ValueError, AttributeError, OSError):
        return False
    return expected == n_found


def is_test_person(video_name):
    """Whether a video (`person{NN}_{class}_d{K}`) is one of persons
    21-25, which are kept for the test set."""
    return int(video_name.split("_")[0][-2:]) > 20


class KTH(VideoDataset):
    classes = CLASSES

    def __init__(self, data, nx, seq_len, train, packed=False):
        # train: [(path, n_frames)] packed, or [frame paths] a video;
        # test: [video]
        self.data = data
        self.nx = nx
        self.seq_len = seq_len
        self.train = train
        self.packed = packed

    def change_seq_len(self, seq_len):
        self.seq_len = seq_len

    def _filter(self, data):
        return KTH(data, self.nx, self.seq_len, self.train, self.packed)

    def __len__(self):
        return 500000 if self.train else len(self.data)

    def _n_frames(self, vid):
        return vid[1] if self.packed else len(vid)

    def _sample_window(self, rng):
        """A random video at least seq_len long, and a window start."""
        while True:
            vid = self.data[rng.randint(len(self.data))]
            if self._n_frames(vid) >= self.seq_len:
                break
        return vid, rng.randint(self._n_frames(vid) - self.seq_len + 1)

    def _windows(self, seeds):
        """The windows get_item draws with RandomState(s) for each seed s:
        memory-mapped frames (packed tree) or frame paths. One generator is
        seeded again per item, the same draws as a new one per item at a
        fiftieth of the host time."""
        rng, windows = np.random.RandomState(), []
        for seed in seeds:
            rng.seed(seed)
            vid, t0 = self._sample_window(rng)
            windows.append(np.load(vid[0], mmap_mode="r")[
                t0:t0 + self.seq_len] if self.packed
                else vid[t0:t0 + self.seq_len])
        return windows

    def frame_paths(self, index, rng):
        """The frame files of the training window get_item draws from
        `rng` (PNG tree)."""
        vid, t0 = self._sample_window(rng)
        return vid[t0:t0 + self.seq_len]

    def get_item(self, index, rng=None):
        """uint8 (T, nx, nx) video: test item `index`, or a random train
        window drawn from `rng`."""
        if not self.train:
            return self.data[index]
        vid, t0 = self._sample_window(rng)
        if self.packed:
            return np.array(np.load(vid[0], mmap_mode="r")
                            [t0:t0 + self.seq_len])
        return native.decode_png_batch(vid[t0:t0 + self.seq_len], self.nx,
                                       self.nx, 1, n_threads=1)

    def get_batch_seeded(self, indices, seeds, n_threads=4):
        """uint8 (B, T, nx, nx): the windows of get_item for RandomState(s)
        for each seed s."""
        windows = self._windows(seeds)
        if self.packed:
            return np.stack(windows)
        return native.decode_png_batch(
            [p for w in windows for p in w], self.nx, self.nx, 1,
            n_threads).reshape(len(seeds), self.seq_len, self.nx, self.nx)

    def get_batch_timemajor_u8(self, indices, seeds, n_threads=4):
        """The same windows as the collated uint8 batch (T, B, nx, nx, 1),
        decoded or copied straight into it."""
        windows = self._windows(seeds)
        if not self.packed:
            return native.decode_png_timemajor(
                [p for w in windows for p in w], len(seeds), self.seq_len,
                self.nx, self.nx, 1, n_threads)
        out = np.empty((self.seq_len, len(seeds), self.nx, self.nx, 1),
                       np.uint8)
        for b, w in enumerate(windows):
            out[:, b, :, :, 0] = w
        return out

    @classmethod
    def make_dataset(cls, data_dir, nx, seq_len, train, prefer_packed=True):
        if not train:
            path = join(data_dir, f"svg_test_set_{seq_len}.npz")
            with np.load(path, allow_pickle=False) as arc:
                sequences = arc["sequences"]
            return cls([sequences[i] for i in range(len(sequences))], nx,
                       seq_len, train)
        packed_root = join(data_dir, f"packed_{nx}")
        found = []
        for c in cls.classes if prefer_packed else ():
            cdir = join(packed_root, c)
            if os.path.isdir(cdir):
                found += [(c, f) for f in sorted(
                    os.listdir(cdir), key=lambda f: os.path.splitext(f)[0])
                    if f.endswith(".npy")]
        if found and packed_tree_complete(packed_root, len(found)):
            data = []
            for c, f in found:
                if is_test_person(f):
                    continue
                path = join(packed_root, c, f)
                data.append((path, len(np.load(path, mmap_mode="r"))))
            return cls(data, nx, seq_len, train, packed=True)
        return cls(png_tree(data_dir, nx, packed_root, len(found)), nx,
                   seq_len, train)


def png_tree(data_dir, nx, packed_root, n_packed):
    """[sorted frame paths] of each training video of the PNG tree, in the
    packed tree's order (srvp_tpu/data/kth.py:148-168)."""
    root = join(data_dir, f"processed_{nx}")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no KTH PNG tree at {root}, and no complete packed tree at "
            f"{packed_root} (its COMPLETE.json must count the {n_packed} "
            "videos found; python -m srvp_tpu_torch.data.pack --dataset kth "
            "writes it)")
    data = []
    for c in CLASSES:
        for vid in sorted(os.listdir(join(root, c))):
            vdir = join(root, c, vid)
            if not os.path.isdir(vdir) or is_test_person(vid):
                continue
            data.append(sorted(join(vdir, img) for img in os.listdir(vdir)
                               if os.path.splitext(img)[1] == ".png"))
    if not any(data):
        raise ValueError(f"the KTH PNG tree at {root} holds no frames")
    return data
