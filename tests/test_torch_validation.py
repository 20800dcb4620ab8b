"""The port's trainer validation (train_lib.make_eval_batch) against the JAX
package's (srvp_tpu/train_lib.py make_eval_batch) on the CPU: the same
weights, the same frames and the JAX draws, dcgan and vgg (skip
connections) at tiny widths, o = 1 and 2. Each video's best prediction PSNR
agrees to 1e-3 dB."""

import numpy as np
import pytest

import jax
import torch

from srvp_tpu import train_lib as jtrain
from srvp_tpu_torch import train_lib
from srvp_tpu_torch.eval_lib import chunk_noise
from tests.torch_port_util import configs, jax_model, port_model, step_noise, t

PSNR_ATOL = 1e-3     # dB
NT, NT_COND, BSZ, N_SAMPLES, CHUNK = 7, 4, 3, 6, 3
VGG = dict(nf=4, nhx=8, ny=4, nz=4, nh_inf=16, nh_res=16, nlayers_inf=2,
           nlayers_res=2, archi="vgg", nt_inf=3, skipco=True)


def jax_validation_draws(key, cfg, o):
    """The draws of srvp_tpu's make_eval_batch(..., key) in the port's
    chunk order: sample s of n_samples takes split(key, n_samples)[s], whose
    forward splits it into (skip, w, y, gen); its eps_y is normal(k_y) and
    its rollout's substeps use the posterior draws over the conditioning
    frames and the prior ones after. Rows of a chunk are video-major."""
    n_steps = o * (NT - 1)
    n_inf = o * (NT_COND - 1)
    eps_y, eps_pos, eps_pri = [], [], []
    for k in jax.random.split(key, N_SAMPLES):
        _, _, k_y, k_gen = jax.random.split(k, 4)
        eps_y.append(t(jax.random.normal(k_y, (BSZ, cfg.ny))))
        pri, pos = step_noise(k_gen, n_steps, BSZ, cfg.nz)
        eps_pos.append(pos[:n_inf])
        eps_pri.append(pri[n_inf:])

    def chunk(draws, c, dim):
        # (samples of the chunk) stacked after the video axis, then folded
        part = torch.stack(draws[c * CHUNK:(c + 1) * CHUNK], dim + 1)
        return part.flatten(dim, dim + 1)

    return [(chunk(eps_y, c, 0), chunk(eps_pos, c, 1), chunk(eps_pri, c, 1))
            for c in range(N_SAMPLES // CHUNK)]


@pytest.mark.parametrize("o", [1, 2])
@pytest.mark.parametrize("over", [{}, VGG], ids=["dcgan", "vgg"])
def test_best_prediction_psnr_matches_jax(over, o):
    jcfg, cfg = configs(**over)
    params, state = jax_model(jcfg, seed=5, conv_gain=10.0)
    rng = np.random.RandomState(7)
    x = rng.rand(NT, BSZ, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)

    jhp = jtrain.TrainHParams(oversampling=o, nt_cond=NT_COND,
                              n_samples_test=N_SAMPLES,
                              val_samples_chunk=CHUNK)
    want = np.asarray(jtrain.make_eval_batch(jcfg, jhp, NT)(
        params, state, jax.numpy.asarray(x), key))

    hp = train_lib.TrainHParams(oversampling=o, nt_cond=NT_COND,
                                n_samples_test=2 * N_SAMPLES,
                                val_samples_chunk=CHUNK)
    eval_batch = train_lib.make_eval_batch(cfg, hp, NT, n_samples=N_SAMPLES)
    got = eval_batch(port_model(params, state, cfg), t(x),
                     eps=jax_validation_draws(key, cfg, o))
    assert got.shape == (BSZ,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PSNR_ATOL)
    # the videos read differently: the check is not of one constant
    assert np.ptp(want) > 0


def test_generator_draws_run_the_same_path():
    """Without injected draws the function draws them itself, in
    eval_lib.chunk_noise's order: the same generator state gives the same
    PSNR as those draws injected."""
    _, cfg = configs()
    model = port_model(*jax_model(configs()[0], seed=5, conv_gain=10.0), cfg)
    x = torch.from_numpy(np.random.RandomState(8).rand(
        NT, BSZ, 64, 64, 1).astype(np.float32))
    hp = train_lib.TrainHParams(oversampling=2, nt_cond=NT_COND,
                                n_samples_test=N_SAMPLES,
                                val_samples_chunk=CHUNK)
    eval_batch = train_lib.make_eval_batch(cfg, hp, NT)
    got = eval_batch(model, x, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    eps = [chunk_noise(cfg, BSZ, CHUNK, NT_COND, NT, 2, 2, gen, "cpu")
           for _ in range(N_SAMPLES // CHUNK)]
    torch.testing.assert_close(eval_batch(model, x, eps=eps), got,
                               rtol=0, atol=0)
