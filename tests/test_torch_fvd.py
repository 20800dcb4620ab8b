"""The port's I3D and FVD (srvp_tpu_torch/metrics/{i3d,fvd}.py) against
the JAX package's on the CPU.

I3D's pieces at small shapes (odd and even sizes, stride 2, TF 'SAME'
padding), one mixed block, and the whole network on 2 videos x 9 frames at
224 x 224 (the least its final (2, 7, 7) pool takes) at rtol 1e-3 / atol
1e-4 (tests/test_i3d_torch_mirror.py), on random weights with random
batch-norm statistics written as the TF-variable npz that both loaders read
(chip_smoke.write_i3d_weights; the pieces on units drawn like
i3d_random_params). The resize, the Fréchet distance, the chunking and
fvd() end to end (relative 1e-5 on the distance)."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.metrics import fvd as jfvd
from srvp_tpu.metrics import i3d as ji3d
from srvp_tpu_torch.metrics import fvd, i3d
from chip_smoke import write_i3d_weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from convert_i3d import expected_variable_specs  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4
FVD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (tests/test_torch_bf16.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_unit(rng, shape, bn=True, bias=False):
    """A JAX-layout unit (DHWIO kernel) with random batch-norm statistics."""
    oc = shape[-1]
    p = {"w": (0.05 * rng.randn(*shape)).astype(np.float32)}
    if bias:
        p["b"] = (0.1 * rng.randn(oc)).astype(np.float32)
    if bn:
        p["mean"] = (0.1 * rng.randn(oc)).astype(np.float32)
        p["var"] = (1 + 0.3 * rng.rand(oc)).astype(np.float32)
        p["beta"] = (0.1 * rng.randn(oc)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def i3d_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("i3d") / "i3d.npz"
    write_i3d_weights(path, 0)
    return path


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def ndhwc(y):
    return y.numpy().transpose(0, 2, 3, 4, 1)


def test_variable_specs_match_the_converter():
    assert i3d.variable_specs() == [(k, tuple(s))
                                    for k, s in expected_variable_specs()]


@pytest.mark.parametrize("shape, k, stride, flags", [
    ((2, 5, 9, 8, 3), 7, (2, 2, 2), {}),          # the stem, odd and even
    ((1, 4, 7, 6, 5), 3, (1, 1, 1), {}),
    ((1, 6, 10, 11, 4), 3, (2, 2, 2), {}),
    ((2, 3, 5, 4, 6), 1, (1, 1, 1), {}),
    ((2, 2, 1, 1, 8), 1, (1, 1, 1), dict(bn=False, relu=False, bias=True)),
])
def test_unit3d_matches_jax(shape, k, stride, flags):
    rng = np.random.RandomState(sum(shape))
    flags = dict(flags)
    bias = flags.pop("bias", False)
    bn = flags.get("bn", True)
    unit = random_unit(rng, (k, k, k, shape[-1], 7), bn=bn, bias=bias)
    x = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(ji3d._unit3d({k_: jnp.asarray(v) for k_, v in unit.items()},
                                  jnp.asarray(x), stride=stride, **flags))
    ours = i3d._unit3d(i3d._unit_from_jax(unit), ncdhw(x), stride=stride,
                       **flags)
    np.testing.assert_allclose(ndhwc(ours), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape, window, stride", [
    ((1, 3, 112, 112, 2), (1, 3, 3), (1, 2, 2)),   # even: pads (0, 1)
    ((1, 3, 9, 7, 2), (1, 3, 3), (1, 2, 2)),       # odd
    ((2, 4, 6, 5, 3), (3, 3, 3), (1, 1, 1)),
    ((1, 5, 7, 8, 3), (3, 3, 3), (2, 2, 2)),
    ((1, 3, 5, 4, 2), (2, 2, 2), (2, 2, 2)),
])
def test_same_max_pool_matches_jax(shape, window, stride):
    # all negative, so a zero-padded pool would differ from the -inf one
    x = np.random.RandomState(1).rand(*shape).astype(np.float32) - 2.0
    ref = np.asarray(ji3d._max_pool3d(jnp.asarray(x), window, stride))
    ours = i3d._max_pool3d(ncdhw(x), window, stride)
    np.testing.assert_array_equal(ndhwc(ours), ref)


def test_valid_avg_pool_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 7, 8, 4).astype(np.float32)
    ref = np.asarray(ji3d._avg_pool3d_valid(jnp.asarray(x), (2, 7, 7)))
    ours = i3d._avg_pool3d_valid(ncdhw(x), (2, 7, 7))
    np.testing.assert_allclose(ndhwc(ours), ref, rtol=1e-6, atol=1e-7)


def test_mixed_block_matches_jax():
    rng = np.random.RandomState(3)
    units = {key: random_unit(rng, shape)
             for key, shape in ji3d._branch_shapes("Mixed_4b")}
    x = np.maximum(rng.randn(1, 3, 5, 6, 480), 0).astype(np.float32)
    ref = np.asarray(ji3d._mixed(
        {k: {kk: jnp.asarray(v) for kk, v in u.items()}
         for k, u in units.items()}, jnp.asarray(x)))
    ours = i3d._mixed({k: i3d._unit_from_jax(u) for k, u in units.items()},
                      ncdhw(x))
    assert ref.shape[-1] == 512
    np.testing.assert_allclose(ndhwc(ours), ref, rtol=RTOL, atol=ATOL)


def test_npz_loader_matches_jax(i3d_npz):
    ref = i3d.i3d_params_from_jax(ji3d.load_i3d_npz(i3d_npz))
    ours = i3d.load_i3d_npz(i3d_npz)
    assert ours.keys() == ref.keys()
    leaves = lambda p: [(n, k, kk, v) for n, node in p.items()  # noqa: E731
                        for k, v in node.items()
                        for kk, v in (v.items() if isinstance(v, dict)
                                      else [(None, v)])]
    assert len(leaves(ours)) == len(leaves(ref)) == len(i3d.variable_specs())
    for (n, k, kk, a), (*_, b) in zip(leaves(ours), leaves(ref)):
        assert a.dtype == torch.float32 and a.is_contiguous(), (n, k, kk)
        assert torch.equal(a, b), (n, k, kk)
    assert ours["Conv3d_1a_7x7"]["w"].shape == (64, 3, 7, 7, 7)


def test_i3d_matches_jax_at_224(i3d_npz):
    videos = np.random.RandomState(4).rand(2, 9, 224, 224, 3) \
        .astype(np.float32) * 2 - 1
    ref = np.asarray(jax.jit(ji3d.i3d_apply)(ji3d.load_i3d_npz(i3d_npz),
                                             jnp.asarray(videos)))
    with torch.no_grad():
        ours = i3d.i3d_apply(i3d.load_i3d_npz(i3d_npz), ncdhw(videos)).numpy()
    assert ours.shape == ref.shape == (2, 400)
    assert np.abs(ref).max() > 1.0       # the logits are not vanishing
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape, size", [
    ((2, 64, 64, 3), (224, 224)), ((1, 8, 5, 2), (16, 7)),
    ((1, 16, 16, 1), (16, 16))])
def test_resize_matches_jax(shape, size):
    x = np.random.RandomState(5).rand(*shape).astype(np.float32) * 255
    ref = np.asarray(jfvd.resize_bilinear_tf1(jnp.asarray(x), size))
    ours = fvd.resize_bilinear_tf1(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-4)


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.randn(40, 12).astype(np.float32)
    b = (1.5 * rng.randn(33, 12) + 0.3).astype(np.float32)
    assert fvd.frechet_distance(a, b) == jfvd.frechet_distance(a, b)
    assert fvd.frechet_distance(a, a) == pytest.approx(0.0, abs=1e-8)


def stub_embed(chunk):
    """A stand-in for I3D that both packages' compute_embeddings take:
    numpy in and out, each video's id at 400 features."""
    return np.asarray(chunk)[:, 0, 0, 0, :1].astype(np.float32) \
        .repeat(400, axis=1)


def test_compute_embeddings_matches_jax():
    n = 17                     # a chunk of 16, then one padded with 15
    vids = (np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1, 1)
            * np.ones((n, 2, 4, 4, 1), np.uint8))
    calls = []

    def embed(chunk):
        calls.append(tuple(chunk.shape))
        return stub_embed(chunk)

    ours = fvd.compute_embeddings(embed, vids)
    np.testing.assert_array_equal(ours, jfvd.compute_embeddings(stub_embed,
                                                                vids))
    assert calls == [(16, 2, 4, 4, 3)] * 2
    np.testing.assert_array_equal(ours[:, 0], np.arange(n))
    with pytest.raises(ValueError, match="at least 16"):
        fvd.compute_embeddings(embed, vids[:15])


def test_fvd_matches_jax(i3d_npz):
    rng = np.random.RandomState(7)
    real = rng.randint(0, 256, (16, 9, 32, 32, 1)).astype(np.uint8)
    fake = np.clip(real.astype(np.int16)
                   + rng.randint(-60, 61, real.shape), 0, 255).astype(np.uint8)
    ref = jfvd.fvd(real, fake, i3d_path=str(i3d_npz))
    ours = fvd.fvd(real, fake, i3d_path=str(i3d_npz), device="cpu")
    assert np.isfinite(ours) and ours > 0
    assert ours == pytest.approx(ref, rel=FVD_RTOL)


def test_fvd_needs_its_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("SRVP_TPU_I3D_WEIGHTS", str(tmp_path / "absent.npz"))
    assert fvd.default_i3d_path() == str(tmp_path / "absent.npz")
    vids = np.zeros((16, 9, 8, 8, 1), np.uint8)
    with pytest.raises(FileNotFoundError, match="I3D"):
        fvd.fvd(vids, vids, device="cpu")
