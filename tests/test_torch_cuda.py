"""The prior-rollout CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from srvp_tpu_torch.config import strict_fp32
from srvp_tpu_torch.kernels import rollout as krollout
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
