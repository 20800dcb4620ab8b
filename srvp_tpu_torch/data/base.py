"""Fold splitting and collation of training videos (counterpart of
srvp_tpu/data/base.py).

Datasets expose `get_item(index, rng)` with an explicit numpy RandomState, so
item randomness is an argument and a seeded loader is reproducible. The
train/val split is the JAX package's: a seed-42 shuffle of the item indices,
95% train, each fold keeping the original item order. `load_dataset` picks
the training dataset by name.
"""

import numpy as np


def load_dataset(opt):
    """The training dataset named by opt.dataset (trainer flags); its folds
    come from get_fold."""
    if opt.dataset == "smmnist":
        from srvp_tpu_torch.data.mmnist import MovingMNIST
        return MovingMNIST.make_dataset(
            opt.data_dir, opt.nx, opt.seq_len, opt.max_speed,
            opt.deterministic, opt.ndigits,
            allow_synthetic=opt.allow_synthetic)
    if opt.dataset == "kth":
        from srvp_tpu_torch.data.kth import KTH
        return KTH.make_dataset(opt.data_dir, opt.nx, opt.seq_len, True)
    raise NotImplementedError(f"dataset {opt.dataset!r} is not ported yet "
                              "(ROADMAP.md, Queue 1)")


def collate_uint8(videos):
    """uint8 videos [(T, H, W) or (T, H, W, C)] -> uint8 (T, B, H, W, C).
    The [0, 1] float conversion happens on the device (objectives.py)."""
    batch = np.stack([v if v.ndim == 4 else v[..., None] for v in videos],
                     axis=1)
    return np.ascontiguousarray(batch)


class VideoDataset:
    """Abstract training dataset; subclasses provide `data`, `train`,
    `get_item(index, rng)` and `_filter(data)`."""

    def get_fold(self, fold):
        if fold not in ("train", "val") or not self.train:
            raise ValueError(f"fold {fold!r} of a training dataset: only "
                             "'train' and 'val'")
        rng = np.random.RandomState(42)
        rand_ids = list(range(len(self.data)))
        rng.shuffle(rand_ids)
        n_train = int(0.95 * len(rand_ids))
        keep = set(rand_ids[:n_train] if fold == "train"
                   else rand_ids[n_train:])
        return self._filter([x for i, x in enumerate(self.data) if i in keep])

    def __len__(self):
        return len(self.data)

    def get_item(self, index, rng):
        raise NotImplementedError

    def _filter(self, data):
        raise NotImplementedError
