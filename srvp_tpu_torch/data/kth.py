"""KTH action videos (numpy copy of the packed-tree path of
srvp_tpu/data/kth.py and of the completion check of srvp_tpu/data/base.py).

Train and validation folds come from the packed tree
`{data_dir}/packed_{nx}/{class}/{video}.npy`, one raw uint8 (T, nx, nx)
array per video (preprocessing/kth/pack.py), whose `COMPLETE.json` marker
must name the number of videos found. Persons 21-25 are the test persons and
are left out. An item is a random video (drawn again while it is shorter
than the window) and a random temporal window of it, drawn from the item's
RandomState in the JAX package's order, so the same seeds give the same
windows. The test fold is `{data_dir}/svg_test_set_{seq_len}.npz`, whose
`sequences` are uint8 (N, T, nx, nx[, 1]).

The PNG tree (`processed_{nx}/`) needs an image decoder that the port does
not carry yet; without a usable packed tree, make_dataset raises.
"""

import json
import os
from os.path import join

import numpy as np

from srvp_tpu_torch.data.base import VideoDataset

CLASSES = ["boxing", "handclapping", "handwaving", "jogging", "running",
           "walking"]
NO_PACKED_TREE = ("the port reads KTH training videos from a packed tree "
                  "only (preprocessing/kth/pack.py writes it); the PNG tree "
                  "is not ported yet (ROADMAP.md, Queue 1)")


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

    def __init__(self, data, nx, seq_len, train):
        self.data = data      # train: [(path, n_frames)]; test: [video]
        self.nx = nx
        self.seq_len = seq_len
        self.train = train

    def change_seq_len(self, seq_len):
        self.seq_len = seq_len

    def _filter(self, data):
        return KTH(data, self.nx, self.seq_len, self.train)

    def __len__(self):
        return 500000 if self.train else len(self.data)

    def get_item(self, index, rng=None):
        """uint8 (T, nx, nx) video: test item `index`, or a random train
        window drawn from `rng`."""
        if not self.train:
            return self.data[index]
        (path, _), t0 = self._sample_window(rng)
        return np.array(np.load(path, mmap_mode="r")[t0:t0 + self.seq_len])

    def _sample_window(self, rng):
        """A random video at least seq_len long, and a window start."""
        while True:
            vid = self.data[rng.randint(len(self.data))]
            if vid[1] >= self.seq_len:
                break
        return vid, rng.randint(vid[1] - self.seq_len + 1)

    @classmethod
    def make_dataset(cls, data_dir, nx, seq_len, train):
        if not train:
            path = join(data_dir, f"svg_test_set_{seq_len}.npz")
            with np.load(path, allow_pickle=False) as arc:
                sequences = arc["sequences"]
            return cls([sequences[i] for i in range(len(sequences))], nx,
                       seq_len, train)
        packed_root = join(data_dir, f"packed_{nx}")
        found = []
        for c in cls.classes:
            cdir = join(packed_root, c)
            if os.path.isdir(cdir):
                found += [(c, f) for f in sorted(
                    os.listdir(cdir), key=lambda f: os.path.splitext(f)[0])
                    if f.endswith(".npy")]
        if not found or not packed_tree_complete(packed_root, len(found)):
            raise FileNotFoundError(
                f"no complete packed KTH tree at {packed_root} (its "
                f"COMPLETE.json must count {len(found)} videos): "
                f"{NO_PACKED_TREE}")
        data = []
        for c, f in found:
            if is_test_person(f):
                continue
            path = join(packed_root, c, f)
            data.append((path, len(np.load(path, mmap_mode="r"))))
        return cls(data, nx, seq_len, train)
