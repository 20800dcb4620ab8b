"""The port's LPIPS (srvp_tpu_torch/metrics/lpips.py) against the JAX
package's on the CPU: the reference golden at its own tolerance (rtol 1e-4,
atol 1e-6, tests/test_lpips.py), random weights carried over from JAX and
read from `.pth` files in both on-disk layouts, the video wrapper on gray
and RGB frames, and the loader's errors."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srvp_tpu.metrics import lpips as jlpips
from srvp_tpu_torch.metrics import lpips
from tests.test_lpips import _random_weights

RTOL, ATOL = 1e-4, 1e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lpips_golden.npz")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def image_pair(seed, n=4, hw=64):
    """NCHW float32 images in [-1, 1] and a noisy copy."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, hw, hw).astype(np.float32) * 2 - 1
    y = np.clip(x + 0.2 * rng.randn(*x.shape).astype(np.float32), -1, 1)
    return x, y


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def port_lpips(params, x, y):
    with torch.no_grad():
        return lpips.alex_lpips_apply(params, torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy()


def test_matches_reference_golden():
    data = np.load(GOLDEN)
    bb_sd = {k[3:]: data[k] for k in data.files if k.startswith("bb/")}
    lin_sd = {k[4:]: data[k] for k in data.files if k.startswith("lin/")}
    params = {"convs": lpips.convert_alexnet_state_dict(bb_sd),
              "lins": lpips.convert_lin_state_dict(lin_sd)}
    ours = port_lpips(params, data["x"], data["y"])
    np.testing.assert_allclose(ours, data["lpips"], rtol=RTOL, atol=ATOL)


def test_matches_jax_on_weights_from_jax():
    bb_sd, lin_sd = _random_weights(seed=4)
    jparams = {"convs": jlpips.convert_alexnet_state_dict(bb_sd),
               "lins": jlpips.convert_lin_state_dict(lin_sd)}
    x, y = image_pair(5)
    ref = np.asarray(jlpips.alex_lpips_apply(jparams, nhwc(x), nhwc(y)))
    params = lpips.lpips_params_from_jax(
        {"convs": [{k: np.asarray(v) for k, v in c.items()}
                   for c in jparams["convs"]],
         "lins": [np.asarray(lin) for lin in jparams["lins"]]})
    assert ref.min() > 0
    np.testing.assert_allclose(port_lpips(params, x, y), ref, rtol=RTOL,
                               atol=ATOL)


def write_lpips_dir(root, layout, seed=3):
    """Random weights as the official files: `flat` is alex.pth beside
    alexnet.pth, `nested` is weights/v0.1/alex.pth beside torchvision's
    alexnet-owt-<hash>.pth."""
    bb_sd, lin_sd = _random_weights(seed=seed)
    root.mkdir(parents=True, exist_ok=True)
    lin_dir = root / "weights" / "v0.1" if layout == "nested" else root
    lin_dir.mkdir(parents=True, exist_ok=True)
    bb_name = "alexnet-owt-7be5be79.pth" if layout == "nested" \
        else "alexnet.pth"
    torch.save({k: torch.from_numpy(v) for k, v in bb_sd.items()},
               root / bb_name)
    torch.save({k: torch.from_numpy(v) for k, v in lin_sd.items()},
               lin_dir / "alex.pth")
    return root


@pytest.mark.parametrize("layout", ["flat", "nested"])
def test_matches_jax_on_pth_files(tmp_path, layout):
    root = write_lpips_dir(tmp_path / layout, layout)
    x, y = image_pair(6, n=3, hw=72)
    ref = np.asarray(jlpips.alex_lpips_apply(
        jlpips.load_lpips_params(str(root)), nhwc(x), nhwc(y)))
    ours = port_lpips(lpips.load_lpips_params(str(root)), x, y)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_zero_on_identical_inputs():
    bb_sd, lin_sd = _random_weights(seed=2)
    params = {"convs": lpips.convert_alexnet_state_dict(bb_sd),
              "lins": lpips.convert_lin_state_dict(lin_sd)}
    x, _ = image_pair(3, n=2)
    np.testing.assert_allclose(port_lpips(params, x, x), 0.0, atol=ATOL)


@pytest.mark.parametrize("missing, match", [
    ("alex.pth", "LPIPS linear weights not found"),
    ("alexnet.pth", "AlexNet backbone weights not found")])
def test_missing_files_raise(tmp_path, missing, match):
    root = write_lpips_dir(tmp_path, "flat")
    (root / missing).unlink()
    for load in (lpips.load_lpips_params, jlpips.load_lpips_params):
        with pytest.raises(FileNotFoundError, match=match):
            load(str(root))


@pytest.mark.parametrize("nc", [1, 3])
def test_video_lpips_matches_jax(tmp_path, nc):
    root = write_lpips_dir(tmp_path, "flat", seed=7)
    rng = np.random.RandomState(nc)
    pred = rng.rand(3, 2, 64, 64, nc).astype(np.float32)
    target = np.clip(pred + 0.1 * rng.randn(*pred.shape), 0, 1) \
        .astype(np.float32)
    ref = np.asarray(jlpips.make_video_lpips(str(root))(
        jnp.asarray(pred), jnp.asarray(target)))
    ours = lpips.make_video_lpips(str(root), torch.device("cpu"))(
        torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert ours.shape == ref.shape == (3, 2)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
