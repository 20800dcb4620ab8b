"""The CUDA kernels against their plain versions, on the card: the prior
rollout, and the training rollout's forward and backward (inputs drawn away
from ReLU kinks by kernels.parity.kink_free_inputs, a float64 run of the
plain version as the arbiter of elements fp32 cannot resolve).

These tests need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from srvp_tpu_torch.config import strict_fp32
from srvp_tpu_torch.kernels import parity
from srvp_tpu_torch.kernels import rollout as krollout
from srvp_tpu_torch.kernels import rollout_train as krt
from srvp_tpu_torch.models.mlp import MLP

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    strict_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("bsz,n_steps,o,ny,nz,nh", [
    (160, 20, 1, 20, 20, 512),    # the main path's chunk
    (1600, 20, 1, 20, 20, 512),   # a whole batch (16-row tiles)
    (600, 6, 2, 20, 12, 64),      # 8-row tiles, ny != nz
    (37, 10, 2, 6, 4, 24),        # ragged tile, narrow layers
    (5, 9, 3, 7, 5, 30),          # widths that are not multiples of 4
])
def test_kernel_matches_plain(cuda, bsz, n_steps, o, ny, nz, nh):
    torch.manual_seed(0)
    pz = MLP(ny, nh, 2 * nz, 4).to(cuda).linears()
    dyn = MLP(ny + nz, nh, ny, 4).to(cuda).linears()
    y0 = torch.randn(bsz, ny, device=cuda)
    eps = torch.randn(n_steps, bsz, nz, device=cuda)
    before = krollout.launches
    with torch.no_grad():
        out = krollout.prior_rollout(pz, dyn, y0, eps, ny, nz, o)
        ref = krollout.prior_rollout_reference(pz, dyn, y0, eps, ny, nz, o)
    torch.cuda.synchronize()
    assert krollout.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def test_kernel_rejects_bad_inputs(cuda):
    pz = MLP(4, 8, 6, 2).to(cuda).linears()
    dyn = MLP(7, 8, 4, 2).to(cuda).linears()
    y0 = torch.zeros(3, 4, device=cuda)
    eps = torch.zeros(2, 3, 3, device=cuda)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0.double(), eps, 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0, eps[:, :2], 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0.t().contiguous().t(), eps, 4, 3)
    with pytest.raises(ValueError):
        krollout.prior_rollout(pz, dyn, y0, eps, 4, 3, 0)


def _train_layers(cuda, nh_inf, nh, ny, nz):
    q = torch.nn.Linear(nh_inf, 2 * nz).to(cuda)
    return ((q.weight, q.bias), MLP(ny, nh, 2 * nz, 4).to(cuda).linears(),
            MLP(ny + nz, nh, ny, 4).to(cuda).linears())


@pytest.mark.parametrize("bsz,n_steps,o,ny,nz,nh_inf,nh", [
    (128, 14, 1, 20, 20, 256, 512),   # the training step
    (37, 10, 2, 20, 12, 24, 64),      # reused z, ny != nz
    (130, 6, 3, 7, 5, 30, 30),        # ragged tile, widths not multiples of 4
])
def test_train_kernels_match_plain(cuda, bsz, n_steps, o, ny, nz, nh_inf,
                                   nh):
    torch.manual_seed(0)
    q, pz, dyn = _train_layers(cuda, nh_inf, nh, ny, nz)
    gen = torch.Generator(device=cuda).manual_seed(1)
    y0, hxz, eps, _ = parity.kink_free_inputs(q, pz, dyn, bsz, n_steps, o,
                                              gen)
    flat = [t.detach() for w, b in [q, *pz, *dyn] for t in (w, b)]
    runs = []
    for fn, dtype in ((krt.train_rollout, torch.float32),
                      (krt.train_rollout_reference, torch.float32),
                      (krt.train_rollout_reference, torch.float64)):
        leaves = [t.to(dtype, copy=True).requires_grad_()
                  for t in [y0, hxz, *flat]]
        pairs = [(leaves[i], leaves[i + 1]) for i in range(2, len(leaves), 2)]
        before = (krt.fwd_launches, krt.bwd_launches)
        outs = fn(pairs[0], pairs[1:5], pairs[5:], leaves[0], leaves[1],
                  eps.to(dtype), o)
        grads = torch.autograd.grad(parity.rollout_loss(outs), leaves)
        runs.append((outs, grads))
        if fn is krt.train_rollout:
            assert (krt.fwd_launches, krt.bwd_launches) == (
                before[0] + 1, before[1] + 2)
    torch.cuda.synchronize()
    # each element within the tolerance of the fp32 plain result, or no
    # farther from the float64 one than that is (parity.agreement)
    for part, rtol, atol in ((0, 2e-5, 1e-6), (1, 5e-4, 5e-6)):
        for i, (a, b, c) in enumerate(zip(*(r[part] for r in runs))):
            assert torch.isfinite(a).all()
            worst = parity.agreement(a, b, c, rtol, atol)[1]
            assert worst <= 1.0, (part, i, worst)


def test_train_kernels_reject_bad_inputs(cuda):
    q, pz, dyn = _train_layers(cuda, 6, 8, 4, 3)
    y0 = torch.zeros(3, 4, device=cuda)
    hxz = torch.zeros(2, 3, 6, device=cuda)
    eps = torch.zeros(2, 3, 3, device=cuda)
    bad = [
        (y0.double(), hxz, eps, 1),
        (y0, hxz[:, :2], eps, 1),
        (y0, hxz, eps[..., :2], 1),
        (y0, hxz.cpu(), eps, 1),
        (y0, hxz, eps, 0),
        (y0[:, :3], hxz, eps, 1),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            krt.train_rollout(q, pz, dyn, *args)
