"""Human3.6M videos, whole in memory (counterpart of
srvp_tpu/data/human.py).

Each video is the uint8 (T, 64, 64, 3) `image` array of one npz file
(preprocessing/human/convert.py): `{data_dir}/train/*.npz` for training and
validation, and the test fold's clips `{data_dir}/test_set_{seq_len}_
{subsampling}/*.npz` (preprocessing/human/make_test_set.py), in sorted file
order. An item is `seq_len` frames taken every `subsampling` frames of a
window of (seq_len - 1) * subsampling + 1: in training a random video
(drawn again while it is shorter than the window) from a random start,
drawn from the item's RandomState in the JAX package's order; in the test
fold clip `index` from frame 0.
"""

import os

import numpy as np

from srvp_tpu_torch.data.base import VideoDataset


class Human(VideoDataset):
    def __init__(self, data, nx, seq_len, subsampling, train):
        self.data = data
        self.nx = nx
        self.train = train
        self.subsampling = subsampling
        self.change_seq_len(seq_len)

    def change_seq_len(self, seq_len):
        """Sets the item length, and the window of original frames it
        spans."""
        self.seq_len = seq_len
        self.actual_seq_len = (seq_len - 1) * self.subsampling + 1

    def _filter(self, data):
        return Human(data, self.nx, self.seq_len, self.subsampling,
                     self.train)

    def __len__(self):
        return 500000 if self.train else len(self.data)

    def get_item(self, index, rng=None):
        """uint8 (seq_len, nx, nx, 3)."""
        if not self.train:
            vid, t0 = self.data[index], 0
        else:
            while True:
                vid = self.data[rng.randint(len(self.data))]
                if len(vid) >= self.actual_seq_len:
                    break
            t0 = rng.randint(len(vid) - self.actual_seq_len + 1)
        return vid[t0:t0 + self.actual_seq_len:self.subsampling]

    @classmethod
    def make_dataset(cls, data_dir, nx, seq_len, subsampling, train):
        folder = os.path.join(data_dir, "train" if train
                              else f"test_set_{seq_len}_{subsampling}")
        data = []
        for name in sorted(os.listdir(folder)):
            with np.load(os.path.join(folder, name)) as arc:
                data.append(arc["image"])
        return cls(data, nx, seq_len, subsampling, train)
