"""The port's bfloat16 compute (the trainer's `--precision bfloat16`) against
the JAX package's `compute_dtype=jnp.bfloat16` on the CPU: the training
step (forward, ELBO, gradients and batch-norm statistics; dcgan, and vgg
with skip connections at o = 1 and 2), the trainer's validation
(`make_eval_batch`) and the evaluation chunk (`compute_chunk`), with the same
weights and the JAX draws; and the layers' bfloat16 semantics on their own.

The conv towers run in bfloat16 and everything else in float32, in both
packages: parameters, batch-norm statistics and running statistics, the
latent model, the rollouts and the loss.

The yardstick (relative L2 norm, over the float32 reference's norm): the
port's distance to the JAX package's bfloat16 run must be at most the JAX
package's own distance from bfloat16 to float32, for each forward output,
for the gradients of the conv towers and of the latent model, each group
taken as one vector, for the running statistics, and for the metrics of
the validation and the evaluation; and for each forward output the
port's own distance from float32 must be at least half of the JAX
package's, so that a port that rounds in fewer places fails. The
distances are printed for each output and each gradient tensor. The JAX side runs as its accelerators
compute bfloat16 (`tpu_like_bf16`): every bfloat16 operation rounds (XLA's
excess-precision liberty, which on the CPU skips roundings where its fusions
fall, is off) and bfloat16 sums accumulate in float32, where XLA:CPU chains
bfloat16 additions (its conv-tower gradients then land several times
farther from float32's than the port's). Its batch variance is taken in
two passes, as in the float32 parity tests (test_torch_train.py).

Not held per tensor or for the scalar loss: each is one sum whose bfloat16
error can cancel to near zero in one run and not in the other, so the
ratio of two such errors says little (the per-tensor distances are
printed). The loss and its terms are held instead at rtol 2^-10, a
quarter of bfloat16's unit roundoff.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax._src.interpreters import mlir
from jax._src.lax import lax as jlax
from jax._src.lib.mlir.dialects import hlo

from srvp_tpu import eval_lib as jeval
from srvp_tpu import train_lib as jtrain
from srvp_tpu.models import layers as jlayers
from srvp_tpu.models import srvp as jsrvp
from srvp_tpu.objectives import elbo_loss as jelbo
from srvp_tpu_torch import eval_lib, train_lib
from srvp_tpu_torch.models import layers
from srvp_tpu_torch.objectives import elbo_loss
from srvp_tpu_torch.utils.weights import bn_state_from_port
from tests.test_torch_train import (LOSS_KW, grads_in_port_layout,
                                    two_pass_bn_stats)
from tests.test_torch_validation import jax_validation_draws
from tests.torch_port_util import (chunk_noise, configs, jax_draws, jax_model,
                                   port_model, t)

LOSS_RTOL = 2.0 ** -10
STRICT = {"xla_allow_excess_precision": False}
VGG = dict(nf=4, nhx=8, ny=4, nz=4, nh_inf=16, nh_res=16, nlayers_inf=2,
           nlayers_res=2, archi="vgg", nt_inf=3, skipco=True)
CASES = [({}, 1), (VGG, 1), (VGG, 2)]
IDS = ["dcgan", "vgg-o1", "vgg-o2"]
OUTPUTS = ("x_", "y", "z", "w", "q_y_0_params", "q_z_params", "p_z_params",
           "res")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test (restored after it): the tier-1
    run shares the CPU among its workers, and timing tests elsewhere in the
    suite read host time."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f32_sum_lower(ctx, x, *, axes, **kw):
    """reduce_sum lowering that accumulates bfloat16 in float32."""
    default = partial(jlax._unary_reduce_lower, hlo.AddOp,
                      jlax._get_sum_identity)
    if ctx.avals_out[0].dtype != jnp.bfloat16:
        return default(ctx, x, axes=axes, **kw)

    def wide(v):
        return jlax.reduce_sum_p.bind(v.astype(jnp.float32), axes=axes,
                                      **kw).astype(jnp.bfloat16)
    return mlir.lower_fun(wide, multiple_results=False)(ctx, x)


@pytest.fixture
def tpu_like_bf16(monkeypatch):
    """JAX bfloat16 sums accumulate in float32 on the CPU, and its batch
    variance is taken in two passes, for the test's duration (the caches
    are cleared on both sides, so no other test sees the lowering)."""
    monkeypatch.setattr(jlayers, "_bn_stats_fwd", two_pass_bn_stats)
    table = mlir._platform_specific_lowerings["cpu"]
    before = table.get(jlax.reduce_sum_p)
    jax.clear_caches()
    mlir.register_lowering(jlax.reduce_sum_p, _f32_sum_lower, platform="cpu")
    try:
        yield
    finally:
        if before is None:
            table.pop(jlax.reduce_sum_p, None)
        else:
            table[jlax.reduce_sum_p] = before
        jax.clear_caches()


def strict(fn, *args):
    """fn(*args) compiled with every bfloat16 operation rounding."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


def distance(a, b, ref):
    """||a - b|| / ||ref||, in float64."""
    a, b, ref = (np.asarray(v, np.float64).ravel() for v in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def hold(name, port, jax_bf16, jax_f32, rounds=False):
    """The yardstick of the module docstring; prints both distances. With
    `rounds`, the port's own distance from float32 must also be at least
    half of JAX's: it rounds where JAX rounds, and no less."""
    ours = distance(port, jax_bf16, jax_f32)
    theirs = distance(jax_bf16, jax_f32, jax_f32)
    own = distance(port, jax_f32, jax_f32)
    print(f"{name}: port-vs-JAX bf16 {ours:.3e}, JAX bf16-vs-fp32 "
          f"{theirs:.3e}, ratio {ours / theirs:.3f}; port bf16-vs-fp32 "
          f"{own:.3e}")
    assert ours <= theirs, name
    assert not rounds or own >= theirs / 2, name
    return ours / theirs


def np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("over,o", CASES, ids=IDS)
def test_bf16_step_matches_jax(over, o, tpu_like_bf16):
    jcfg, cfg = configs(**over)
    params, state = jax_model(jcfg, seed=1, conv_gain=10.0)
    nt, bsz = 5, 4
    x = np.random.RandomState(0).rand(nt, bsz, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(oversampling=o, **LOSS_KW)
    ref = {}
    for dt in (jnp.float32, jnp.bfloat16):
        out = strict(lambda p, dt=dt: jsrvp.forward(
            jcfg, p, state, jnp.asarray(x), nt, oversampling=o, rng=key,
            train=True, compute_dtype=dt), params)
        (loss, aux), grads = strict(jax.value_and_grad(
            lambda p, dt=dt: jelbo(jcfg, p, state, x, key, compute_dtype=dt,
                                   **kw), has_aux=True), params)
        ref[dt] = (out, loss, aux, grads_in_port_layout(grads, state, cfg))
    (out_f, loss_f, aux_f, g_f), (out_b, loss_b, aux_b, g_b) = (
        ref[jnp.float32], ref[jnp.bfloat16])

    draws = jax_draws(key, jcfg, nt, bsz, o)
    model = port_model(params, state, cfg).train()
    with torch.no_grad():
        out = model(t(x), nt, o, compute_dtype=torch.bfloat16, **draws)
    assert out.x_.dtype == torch.bfloat16
    assert all(getattr(out, k).dtype == torch.float32 for k in OUTPUTS[1:])
    for k in OUTPUTS:
        hold(k, getattr(out, k).float(), np32(getattr(out_b, k)),
             np32(getattr(out_f, k)), rounds=True)

    model = port_model(params, state, cfg).train()
    loss, aux = elbo_loss(model, t(x), compute_dtype=torch.bfloat16, **kw,
                          **draws)
    loss.backward()
    print(f"loss: port-vs-JAX bf16 "
          f"{abs(loss.item() - float(loss_b)) / abs(float(loss_f)):.3e}, "
          f"JAX bf16-vs-fp32 "
          f"{abs(float(loss_b) - float(loss_f)) / abs(float(loss_f)):.3e}")
    np.testing.assert_allclose(loss.item(), float(loss_b), rtol=LOSS_RTOL)
    for k in ("nll", "kl_y_0", "kl_z", "l2_res"):
        np.testing.assert_allclose(getattr(aux, k).item(),
                                   float(getattr(aux_b, k)), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    named = dict(model.named_parameters())
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in named.values())
    for name, p in named.items():
        print(f"  {name}: port-vs-JAX bf16 "
              f"{distance(p.grad, g_b[name], g_f[name]):.3e}, JAX "
              f"bf16-vs-fp32 {distance(g_b[name], g_f[name], g_f[name]):.3e}")
    for group in ("conv", "latent"):
        names = [n for n in named
                 if (n.split(".")[0] in ("encoder", "decoder"))
                 == (group == "conv")]
        hold(f"{group} gradients",
             np.concatenate([named[n].grad.numpy().ravel() for n in names]),
             np.concatenate([g_b[n].numpy().ravel() for n in names]),
             np.concatenate([g_f[n].numpy().ravel() for n in names]))
    leaves = lambda tree: np.concatenate([  # noqa: E731
        np.asarray(v).ravel() for v in jax.tree_util.tree_leaves(tree)])
    ours = bn_state_from_port(model.state_dict(), cfg)
    assert leaves(ours).dtype == np.float32
    hold("running statistics", leaves(ours), leaves(aux_b.state),
         leaves(aux_f.state))


NT, NT_COND, BSZ, N_SAMPLES, CHUNK = 7, 4, 3, 6, 3


@pytest.mark.parametrize("over", [{}, VGG], ids=["dcgan", "vgg"])
def test_bf16_validation_matches_jax(over, tpu_like_bf16):
    """make_eval_batch in bfloat16: each video's best prediction PSNR."""
    jcfg, cfg = configs(**over)
    params, state = jax_model(jcfg, seed=5, conv_gain=10.0)
    x = np.random.RandomState(7).rand(NT, BSZ, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jhp = jtrain.TrainHParams(oversampling=2, nt_cond=NT_COND,
                                  n_samples_test=N_SAMPLES,
                                  val_samples_chunk=CHUNK, compute_dtype=dt)
        fn = jtrain.make_eval_batch(jcfg, jhp, NT)
        want[dt] = np.asarray(strict(fn, params, state, jnp.asarray(x), key))
    hp = train_lib.TrainHParams(oversampling=2, nt_cond=NT_COND,
                                n_samples_test=N_SAMPLES,
                                val_samples_chunk=CHUNK,
                                compute_dtype=torch.bfloat16)
    got = train_lib.make_eval_batch(cfg, hp, NT)(
        port_model(params, state, cfg), t(x),
        eps=jax_validation_draws(key, cfg, 2))
    assert got.dtype == torch.float32
    hold("best prediction PSNR", got, want[jnp.bfloat16], want[jnp.float32])


@pytest.mark.parametrize("over", [{}, VGG], ids=["dcgan", "vgg"])
def test_bf16_compute_chunk_matches_jax(over, tpu_like_bf16):
    """compute_chunk in bfloat16: the metrics and the u8 frames."""
    nt_cond, nt_test, o = 4, 7, 2
    jcfg, cfg = configs(**over)
    params, state = jax_model(jcfg, seed=6, res_gain=1.2, conv_gain=10.0)
    x = np.random.RandomState(3).rand(nt_test, BSZ, 64, 64, 1).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), CHUNK)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jeval.make_test_chunk(jcfg, nt_cond, nt_test, o, o,
                                   compute_dtype=dt, use_fused_rollout=False)
        want[dt] = strict(fn, params, state, jnp.asarray(x[:nt_cond]),
                          jnp.asarray(x[nt_cond:]), keys)
    eps = chunk_noise(keys[0], cfg, BSZ * CHUNK, nt_cond, nt_test - nt_cond,
                      o, o)
    x_pred, x_rec, metrics = eval_lib.compute_chunk(
        port_model(params, state, cfg), t(x[:nt_cond]), t(x[nt_cond:]),
        CHUNK, o, o, eps, compute_dtype=torch.bfloat16)
    (jf_pred, jf_rec, jf_m), (jb_pred, jb_rec, jb_m) = (
        want[jnp.float32], want[jnp.bfloat16])
    assert x_pred.dtype == x_rec.dtype == torch.uint8
    for k in ("psnr", "ssim"):
        hold(k, metrics[k], jb_m[k], jf_m[k])
    for name, ours, b, f in (("x_pred", x_pred, jb_pred, jf_pred),
                             ("x_rec", x_rec, jb_rec, jf_rec)):
        hold(f"{name} (u8)", ours.numpy().astype(np.float64),
             np.asarray(b, np.float64), np.asarray(f, np.float64))


def test_bf16_batch_norm_follows_jax_bn_apply():
    """BatchNorm2d on bfloat16: float32 statistics of the upcast input
    (two passes), scale and shift formed in float32 and rounded to
    bfloat16, x * scale + shift in bfloat16, float32 running statistics;
    its backward against float64 autograd of the same formula."""
    rng = np.random.RandomState(0)
    x32 = torch.from_numpy((3 + 2 * rng.randn(6, 5, 8, 8)).astype(
        np.float32))
    x = x32.to(torch.bfloat16).requires_grad_()
    bn = layers.BatchNorm2d(5, eps=layers.BN_EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(5).astype(np.float32) + .5))
        bn.bias.copy_(torch.from_numpy(rng.randn(5).astype(np.float32)))
    y = bn.train()(x)
    assert y.dtype == torch.bfloat16
    xf = x.detach().double()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    inv = 1 / torch.sqrt(var.float() + layers.BN_EPS)
    scale = (bn.weight * inv).to(torch.bfloat16)
    shift = (bn.bias - bn.weight * mean.float() * inv).to(torch.bfloat16)
    want = x.detach() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    assert torch.equal(y, want)
    n = xf.numel() // 5
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    torch.testing.assert_close(bn.running_mean, 0.1 * mean.float(),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * n / (n - 1) * var.float(),
                               rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(
        torch.bfloat16)
    y.backward(g)
    x64 = xf.clone().requires_grad_()
    w64, b64 = bn.weight.double(), bn.bias.double()
    m64, v64 = x64.mean(dim=(0, 2, 3)), x64.var(dim=(0, 2, 3),
                                                 unbiased=False)
    y64 = ((x64 - m64.view(1, -1, 1, 1))
           * (w64 / torch.sqrt(v64 + layers.BN_EPS)).view(1, -1, 1, 1)
           + b64.view(1, -1, 1, 1))
    y64.backward(g.double())
    assert x.grad.dtype == torch.bfloat16
    assert bn.weight.grad.dtype == torch.float32
    # within a few bfloat16 roundings of the exact gradient
    err = (x.grad.double() - x64.grad).norm() / x64.grad.norm()
    assert err < 2 ** -6, err
    # eval mode: the running statistics
    y_eval = bn.eval()(x.detach())
    inv = 1 / torch.sqrt(bn.running_var + layers.BN_EPS)
    want = (x.detach() * (bn.weight * inv).to(torch.bfloat16).view(
        1, -1, 1, 1) + (bn.bias - bn.weight * bn.running_mean * inv).to(
            torch.bfloat16).view(1, -1, 1, 1))
    assert torch.equal(y_eval, want)


def test_bf16_layers_cast_weights_and_keep_fp32_paths():
    """The convs cast their float32 weights to the input's dtype (the
    gradient reaches the float32 weight), LeakyReLU's slope is taken in
    the input's dtype as jax.nn.leaky_relu takes it, and float32 inputs
    run torch's own modules, bit for bit."""
    torch.manual_seed(0)
    conv = layers.Conv2d(3, 4, 3, 1, 1, bias=False)
    convt = layers.ConvTranspose2d(3, 4, 4, 2, 1, bias=False)
    x = torch.randn(2, 3, 8, 8)
    for m, plain in ((conv, torch.nn.Conv2d), (convt,
                                               torch.nn.ConvTranspose2d)):
        assert isinstance(m, plain) and m.weight.dtype == torch.float32
        assert torch.equal(m(x), plain.forward(m, x))
        xb = x.to(torch.bfloat16)
        y = m(xb)
        assert y.dtype == torch.bfloat16
        want = (torch.nn.functional.conv2d if m is conv else
                torch.nn.functional.conv_transpose2d)(
            xb, m.weight.to(torch.bfloat16), None, m.stride, m.padding)
        assert torch.equal(y, want)
        y.float().sum().backward()
        assert m.weight.grad.dtype == torch.float32
    act = layers.LeakyReLU(0.2)
    v = torch.tensor([-1.0, -3.0, 0.0, 2.0])
    assert torch.equal(act(v), torch.nn.LeakyReLU(0.2)(v))
    got = act(v.to(torch.bfloat16))
    ref = jax.nn.leaky_relu(jnp.asarray(v.numpy(), jnp.bfloat16), 0.2)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref).astype(np.float32))
    assert got[0].item() == -0.2001953125


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_batch_norm_and_leaky_relu_are_torchs_outside_bf16(dtype):
    """Only a bfloat16 input takes the JAX package's bf16 batch norm and
    slope: a float64 (or float32) model's BatchNorm2d and LeakyReLU equal
    torch's modules bit for bit, forward, backward and running statistics,
    in training and in evaluation."""
    torch.manual_seed(0)
    bn = layers.BatchNorm2d(5, eps=layers.BN_EPS).to(dtype)
    ref = torch.nn.BatchNorm2d(5, eps=layers.BN_EPS).to(dtype)
    with torch.no_grad():
        for m in (bn, ref):
            m.weight.copy_(torch.linspace(0.5, 1.5, 5))
            m.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    act, ref_act = layers.LeakyReLU(0.2), torch.nn.LeakyReLU(0.2)
    x = (3 * torch.randn(4, 5, 6, 6) + 1).to(dtype)
    g = torch.randn(4, 5, 6, 6).to(dtype)
    for train in (True, False):
        bn.train(train), ref.train(train)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = act(bn(xa)), ref_act(ref(xb))
        assert ya.dtype == dtype and torch.equal(ya, yb)
        ya.backward(g), yb.backward(g)
        assert torch.equal(xa.grad, xb.grad)
    for p, q in zip(bn.parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, ref.state_dict()[k]), k


def test_bf16_train_step_keeps_fp32_state():
    """Three steps in bfloat16 leave parameters, gradients, Adam's moments
    and the running statistics in float32, with a finite loss, and move
    from the float32 steps by no more than bfloat16 would."""
    _, cfg = configs(**VGG)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        torch.manual_seed(0)
        hp = train_lib.TrainHParams(oversampling=2, compute_dtype=dtype,
                                    **LOSS_KW)
        ts = train_lib.init_train_state(cfg, hp, "cpu")
        x = torch.from_numpy(np.random.RandomState(1).rand(
            5, 3, 64, 64, 1).astype(np.float32))
        gen = torch.Generator().manual_seed(2)
        losses = [float(train_lib.train_step(ts, x, hp, generator=gen)[
            "loss"]) for _ in range(3)]
        assert np.all(np.isfinite(losses))
        sd = ts.model.state_dict()
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in sd.values())
        for st in ts.optimizer.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype \
                == torch.float32
        runs[dtype] = losses
    np.testing.assert_allclose(runs[torch.bfloat16], runs[torch.float32],
                               rtol=2.0 ** -6)
