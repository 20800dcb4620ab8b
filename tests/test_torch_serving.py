"""The port's serving export (srvp_tpu_torch/export.py), its custom ops
(kernels/ops.py) and its in-program noise (ops/counter_rng.py) on the CPU.

At the tiny widths of tests/test_export.py (nf 4, nhx 16, ny = nz = 4),
dcgan and vgg with skip connections, o = 2, 3 + 3 frames:

  * the serving core against the JAX package's serving function's float
    path, srvp.forward(train=False), on the JAX draws: frames within
    atol 2e-4 before quantisation and uint8 at most one level apart in
    float32; in bfloat16 the port's frames as close to JAX's bfloat16 ones
    as JAX's bfloat16 frames are to its float32 ones (the rule of
    tests/test_torch_bf16.py); where the conv gain makes the vgg tower
    amplify float32 rounding, both packages' float32 frames against the
    port's float64 ones;
  * the serving core against eval_lib.compute_chunk at S = 1 on the same
    noise;
  * the artifact against the live serving core, bit for bit (the
    counterpart of tests/test_export.py:34), its graph holding the kernels
    as `srvp.*` nodes and no plain prior rollout, batch polymorphism,
    seeds, a pinned batch, the file format;
  * torch.library.opcheck of the three ops; Philox4x32-10 against an
    independent numpy version and its published answers, the normals'
    moments, the noise's shapes and its independence of the batch size.

Each architecture is exported once (dcgan once more with a pinned batch).
"""

import copy
import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srvp_tpu.models import srvp as jsrvp
from srvp_tpu_torch import eval_lib
from srvp_tpu_torch import export as ex
from srvp_tpu_torch.config import cudnn_deterministic, no_tf32
from srvp_tpu_torch.kernels import ops  # noqa: F401  (registers srvp::*)
from srvp_tpu_torch.kernels.spatial import use_kernels
from srvp_tpu_torch.models import srvp as psrvp
from srvp_tpu_torch.ops import counter_rng as cr
from tests.test_torch_bf16 import (distance, hold, strict,  # noqa: F401
                                   tpu_like_bf16)
from tests.torch_port_util import (configs, jax_model, port_model, step_noise,
                                   t)

TINY = dict(nx=64, nc=1, nf=4, nhx=16, ny=4, nz=4, nt_inf=2, nh_inf=8,
            nlayers_inf=2, nh_res=16, nlayers_res=2)
ARCHS = {"dcgan": dict(archi="dcgan", skipco=False),
         "vgg": dict(archi="vgg", skipco=True)}
# conv kernels scaled so that the decoded frames span the uint8 range
# (std 0.2 at dcgan, 0.17 at vgg; at 5 both are flat, std < 0.01). At 10
# the vgg tower amplifies float32 rounding: each package's float32 frames
# lie up to 5.5e-4 from float64's there
# (test_vgg_float32_rounding_at_gain_10)
CONV_GAIN = {"dcgan": 10.0, "vgg": 7.0}
NT_COND, NT_GEN, O, BSZ = 3, 6, 2, 3
ATOL = 2e-4
PINNED = 2


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def frames_u8(rng, bsz, nt=NT_COND):
    return rng.randint(0, 256, (nt, bsz, 64, 64, 1)).astype(np.uint8)


_BUILT = {}


def build(arch, tmp_dir):
    """JAX weights, the port's model and serving core holding them, and
    the core's fp32 artifact (symbolic batch) loaded on the CPU; once per
    architecture."""
    if arch in _BUILT:
        return _BUILT[arch]
    torch.set_num_threads(2)
    jcfg, cfg = configs(**TINY, **ARCHS[arch])
    params, state = jax_model(jcfg, seed=2, conv_gain=CONV_GAIN[arch])
    model = port_model(params, state, cfg)
    core = ex.make_serving_fn(cfg, model, NT_GEN, oversampling=O,
                              compute_dtype=torch.float32)
    cache = dict(psrvp._INDICES)
    blob = ex.export_serving(cfg, model, NT_COND, NT_GEN, oversampling=O,
                             compute_dtype=torch.float32)
    cache_after = dict(psrvp._INDICES)
    path = tmp_dir / f"{arch}.srvptex"
    ex.save_serving(path, blob)
    fn, header = ex.load_serving(path, "cpu")
    _BUILT[arch] = dict(arch=arch, jcfg=jcfg, cfg=cfg, params=params,
                        state=state, model=model, core=core, blob=blob,
                        path=path, fn=fn, header=header, cache=cache,
                        cache_after=cache_after)
    return _BUILT[arch]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return tmp_path_factory.mktemp("serving")


@pytest.fixture(params=list(ARCHS))
def served(request, artifacts):
    return build(request.param, artifacts)


def jax_frames(s, x_u8, key, dtype=jnp.float32):
    """srvp.forward(train=False)'s clipped frames (the JAX serving
    function's float path), compiled with every bfloat16 rounding."""
    x = jnp.asarray(x_u8).astype(jnp.float32) / 255.0
    out = strict(lambda p: jsrvp.forward(
        s["jcfg"], p, s["state"], x.astype(dtype), NT_GEN, oversampling=O,
        rng=key, train=False, compute_dtype=dtype).x_, s["params"])
    return np.clip(np.asarray(out.astype(jnp.float32)), 0.0, 1.0)


def jax_noise(key, cfg, bsz):
    """The draws of srvp.forward(train=False, rng=key) as the serving
    core's (eps_y, eps_inf, eps_gen)."""
    _, _, k_y, k_gen = jax.random.split(key, 4)
    eps_pri, eps_pos = step_noise(k_gen, O * (NT_GEN - 1), bsz, cfg.nz)
    n_inf = O * (NT_COND - 1)
    return (t(jax.random.normal(k_y, (bsz, cfg.ny))), eps_pos[:n_inf],
            eps_pri[n_inf:])


def float64_frames(s, x_u8, eps):
    """The port's clipped frames in float64, with the plain pools,
    upsamples and rollout: the arbiter of the float32 comparison."""
    model = copy.deepcopy(s["model"]).double()
    use_kernels(model, False)
    x = torch.from_numpy(x_u8).double() / 255.0
    with torch.no_grad():
        w, y_inf, y_gen, skips = eval_lib.sample_latents(
            model, x, 1, NT_GEN - NT_COND + 1, O, O,
            [e.double() for e in eps], use_kernel_rollout=False)
        return model.decode(w, torch.cat([y_inf, y_gen[1:]]),
                            skips).clamp(0.0, 1.0)


def test_serving_core_matches_jax_fp32(served):
    rng = np.random.RandomState(0)
    x = frames_u8(rng, BSZ)
    key = jax.random.PRNGKey(5)
    ref = jax_frames(served, x, key)
    eps = jax_noise(key, served["cfg"], BSZ)
    with torch.no_grad():
        got = served["core"].predict(torch.from_numpy(x), eps)
        u8 = served["core"].serve_with_noise(torch.from_numpy(x), eps)
    assert got.shape == (NT_GEN, BSZ, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    ref_u8 = np.round(ref * 255.0).astype(np.uint8)
    assert np.abs(u8.numpy().astype(int) - ref_u8).max() <= 1
    assert 0.05 < ref.std()            # frames with structure to compare


def test_vgg_float32_rounding_at_gain_10():
    """At conv gain 10 the vgg tower amplifies float32 rounding past ATOL
    in both packages: JAX's float32 frames, too, lie more than ATOL from
    the float64 frames, and the port's lie no farther from them than
    JAX's, in the L2 norm (test_torch_bf16's yardstick)."""
    jcfg, cfg = configs(**TINY, **ARCHS["vgg"])
    params, state = jax_model(jcfg, seed=2, conv_gain=10.0)
    s = dict(jcfg=jcfg, params=params, state=state,
             model=port_model(params, state, cfg))
    core = ex.make_serving_fn(cfg, s["model"], NT_GEN, oversampling=O,
                              compute_dtype=torch.float32)
    x = frames_u8(np.random.RandomState(0), BSZ)
    key = jax.random.PRNGKey(5)
    ref = jax_frames(s, x, key)
    eps = jax_noise(key, cfg, BSZ)
    with torch.no_grad():
        got = core.predict(torch.from_numpy(x), eps).numpy()
    f64 = float64_frames(s, x, eps).numpy()
    port_err, jax_err = np.abs(got - f64).max(), np.abs(ref - f64).max()
    ours, theirs = distance(got, f64, f64), distance(ref, f64, f64)
    print(f"max |float32 - float64|: port {port_err:.3e}, JAX "
          f"{jax_err:.3e}; L2 distances {ours:.3e}, {theirs:.3e}; "
          f"|port - JAX| {np.abs(got - ref).max():.3e}")
    assert jax_err > ATOL and ref.std() > 0.3
    assert ours <= theirs


def test_serving_core_matches_jax_bf16(served, tpu_like_bf16):  # noqa: F811
    rng = np.random.RandomState(1)
    x = frames_u8(rng, BSZ)
    key = jax.random.PRNGKey(6)
    ref32 = jax_frames(served, x, key)
    ref16 = jax_frames(served, x, key, jnp.bfloat16)
    core = ex.make_serving_fn(served["cfg"], served["model"], NT_GEN,
                              oversampling=O, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        got = core.predict(torch.from_numpy(x),
                           jax_noise(key, served["cfg"], BSZ))
    assert got.dtype == torch.float32
    hold("frames", got.numpy(), ref16, ref32)


def test_serving_core_is_compute_chunks_sample(served):
    """The serving core's prediction is compute_chunk's sample at S = 1 on
    the same noise (one decode of all nt_gen frames instead of two; the
    CPU's convs may round another batch differently)."""
    x = frames_u8(np.random.RandomState(7), BSZ)
    eps = cr.serving_noise(torch.tensor(8), BSZ, served["cfg"].ny,
                           served["cfg"].nz, NT_COND, NT_GEN, O, O, "cpu")
    xf = torch.from_numpy(x).float() / 255.0
    target = torch.zeros((NT_GEN - NT_COND,) + xf.shape[1:])
    with torch.no_grad():
        got = served["core"].predict(torch.from_numpy(x), eps)
    pred_u8, rec_u8, _ = eval_lib.compute_chunk(
        served["model"], xf, target, 1, O, O, eps,
        compute_dtype=torch.float32)
    whole = torch.cat([rec_u8, pred_u8[0]], 1).transpose(0, 1)
    d = (eval_lib._to_u8(got).transpose(0, 1).int() - whole.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3
    assert got[NT_COND:].std() > 0.05


def test_artifact_equals_live_core(served):
    x = torch.from_numpy(frames_u8(np.random.RandomState(2), BSZ))
    seed = torch.tensor(11)
    got = served["fn"](x, seed)
    with torch.no_grad():
        live = served["core"](x, seed)
    assert got.dtype == torch.uint8 and got.shape == (NT_GEN, BSZ, 64, 64, 1)
    assert torch.equal(got, live)
    # the seed as a plain int and the frames as numpy serve alike
    assert torch.equal(served["fn"](x.numpy(), 11), got)


def test_graph_calls_the_kernels_and_no_plain_rollout(served):
    header, start = ex.read_header(served["blob"])
    ep = torch.export.load(io.BytesIO(served["blob"][start:]))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    targets = {n.target for n in calls}
    srvp_ops = torch.ops.srvp
    assert srvp_ops.prior_rollout.default in targets
    spatial = {srvp_ops.max_pool2x2.default, srvp_ops.upsample2x.default}
    assert (spatial <= targets) == (served["arch"] == "vgg")
    assert sum(n.target == srvp_ops.prior_rollout.default
               for n in calls) == 1
    # the dynamics MLP's first layer runs once a posterior substep; a
    # plain prior rollout in the graph would add one a prior substep
    params = ep.graph_signature.inputs_to_parameters
    first = [n for n in calls if n.target == torch.ops.aten.linear.default
             and params.get(n.args[1].name, "").endswith(
                 "dynamics.module.0.0.weight")]
    assert len(first) == O * (NT_COND - 1)


def test_export_leaves_the_index_cache_alone(served):
    assert served["cache_after"].keys() == served["cache"].keys()


def test_batch_polymorphism_and_seeds(served):
    fn = served["fn"]
    rng = np.random.RandomState(3)
    x8 = frames_u8(rng, 8)
    outs = {b: fn(x8[:, :b], 4) for b in (1, 3, 8)}
    for b, y in outs.items():
        assert y.shape == (NT_GEN, b, 64, 64, 1)
    assert torch.equal(fn(x8[:, :3], 4), outs[3])
    other = fn(x8[:, :3], 5)
    assert not torch.equal(other[NT_COND:], outs[3][NT_COND:])
    # each row's noise does not depend on the batch; the CPU's convs may
    # round another batch differently
    d = (outs[3][:, :1].int() - outs[1].int()).abs().max()
    assert int(d) <= 1


def test_pinned_batch(artifacts, tmp_path):
    served = build("dcgan", artifacts)
    blob = ex.export_serving(served["cfg"], served["model"], NT_COND, NT_GEN,
                             oversampling=O, compute_dtype=torch.float32,
                             batch_size=PINNED)
    path = tmp_path / "pinned.srvptex"
    ex.save_serving(path, blob)
    fn, header = ex.load_serving(path, "cpu")
    assert header["batch"] == PINNED
    x = frames_u8(np.random.RandomState(4), 8)
    assert torch.equal(fn(x[:, :PINNED], 9), served["fn"](x[:, :PINNED], 9))
    with pytest.raises(ValueError, match="pinned"):
        fn(x, 9)


def test_format(served, tmp_path):
    header = served["header"]
    jax_keys = {"format", "nt_cond", "nt_gen", "nx", "nc", "oversampling",
                "compute_dtype", "platforms", "batch", "calling_convention"}
    assert jax_keys <= set(header)
    assert header["platforms"] == ["cuda", "cpu"]
    assert header["batch"] == "symbolic"
    assert (header["nt_cond"], header["nt_gen"], header["oversampling"]) == (
        NT_COND, NT_GEN, O)
    assert header["compute_dtype"] == "float32"
    assert "seed int64[]" in header["calling_convention"]
    blob = served["blob"]
    for magic in (b"NOTSRVP!", b"SRVPEXP1"):
        bad = tmp_path / "bad.bin"
        bad.write_bytes(magic + blob[8:])
        with pytest.raises(ValueError, match="bad magic"):
            ex.load_serving(bad, "cpu")
    with pytest.raises(ValueError, match="not meta"):
        ex.load_serving(served["path"], "meta")
    with pytest.raises(ValueError, match="expected"):
        served["fn"](np.zeros((NT_COND + 1, 2, 64, 64, 1), np.uint8), 0)


# -- the custom ops ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["max_pool2x2", "upsample2x"])
def test_opcheck_spatial(op, dtype):
    x = torch.randn(3, 4, 6, 8, generator=torch.Generator().manual_seed(0))
    torch.library.opcheck(getattr(torch.ops.srvp, op).default,
                          (x.to(dtype),))


def test_opcheck_prior_rollout():
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    args = ([r(8, 4), r(6, 8)], [r(8), r(6)], [r(8, 7), r(4, 8)],
            [r(8), r(4)], r(5, 4), r(6, 5, 3), 4, 3, 2)
    torch.library.opcheck(torch.ops.srvp.prior_rollout.default, args)
    torch.library.opcheck(torch.ops.srvp.prior_rollout.default,
                          args + (8, 2))


# -- the noise ---------------------------------------------------------------

def philox_numpy(counter, key):
    """Philox4x32-10 in numpy uint64 (an independent version)."""
    c = [np.asarray(v, np.uint64) for v in counter]
    k = [np.asarray(v, np.uint64) for v in key]
    mask = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & mask,
                 (k[1] + np.uint64(0xBB67AE85)) & mask]
        p0 = c[0] * np.uint64(0xD2511F53)    # < 2^64: exact in uint64
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & mask]
    return c


def test_philox_matches_numpy_and_the_published_answers():
    rng = np.random.RandomState(0)
    counter = [rng.randint(0, 2 ** 32, 1000, dtype=np.uint64)
               for _ in range(4)]
    key = [rng.randint(0, 2 ** 32, 1000, dtype=np.uint64) for _ in range(2)]
    got = cr.philox4x32([torch.from_numpy(v.astype(np.int64))
                         for v in counter],
                        [torch.from_numpy(v.astype(np.int64)) for v in key])
    for g, w in zip(got, philox_numpy(counter, key)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    # Random123's known-answer vectors of philox4x32-10
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xffffffff,) * 4, (0xffffffff,) * 2,
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        out = cr.philox4x32([torch.tensor(v) for v in ctr],
                            [torch.tensor(v) for v in key])
        assert tuple(int(v) for v in out) == want


def test_normals_moments():
    n = 10 ** 6
    z = cr.normals(torch.tensor(123), [(cr.STREAM_GEN, 1000, 1000)], 1,
                   "cpu")[0].double().reshape(-1)
    assert z.numel() == n and z.dtype == torch.float64
    assert abs(z.mean().item()) < 5 / np.sqrt(n)
    assert abs(z.var().item() - 1.0) < 5 * np.sqrt(2.0 / n)


def test_noise_shapes_and_rows():
    _, cfg = configs(**TINY)
    seed = torch.tensor(-7)
    got = cr.serving_noise(seed, 3, cfg.ny, cfg.nz, NT_COND, NT_GEN, O, O,
                           "cpu")
    want = eval_lib.chunk_noise(cfg, 3, 1, NT_COND, NT_GEN, O, O,
                                torch.Generator(), "cpu")
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    wide = cr.serving_noise(seed, 5, cfg.ny, cfg.nz, NT_COND, NT_GEN, O, O,
                            "cpu")
    assert torch.equal(wide[0][:3], got[0])
    for g, w in zip(got[1:], wide[1:]):
        assert torch.equal(w[:, :3], g)
    other = cr.serving_noise(torch.tensor(-6), 3, cfg.ny, cfg.nz, NT_COND,
                             NT_GEN, O, O, "cpu")
    assert not any(torch.equal(a, b) for a, b in zip(got, other))
    assert cr.fold_in(0, 1) != cr.fold_in(1, 0)
    assert cr.fold_in(3, 2) == cr.fold_in(3, 2) >= 0


def test_cudnn_deterministic_restores():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    with cudnn_deterministic():
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cudnn.deterministic, cudnn.benchmark) == before


def test_serving_call_scopes_tf32(artifacts):
    """no_tf32 and a loaded artifact's call turn TF32 off for the call
    alone; loading leaves the process's settings as they were."""
    served = build("dcgan", artifacts)
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with no_tf32():
            assert not any(f.allow_tf32 for f in flags)
        fn, _ = ex.load_serving(served["path"], "cpu")
        fn(frames_u8(np.random.RandomState(9), 1), 0)
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
