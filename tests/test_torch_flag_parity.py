"""The port's trainer takes every flag of the JAX trainer (srvp_tpu/args.py)
with the same type, default, `required` and choices, reads `--config FILE`
as the JAX parser does, prunes periodic snapshots to `--keep_chkpt`, and
selects bfloat16 compute from the mixed-precision flags as the JAX trainer
does, and rejects the flags of parts it has not ported when they are
set."""

import os

import pytest

import torch

from srvp_tpu import args as jax_args
from srvp_tpu import train_main as jax_train_main
from srvp_tpu.helper import DotDict
from srvp_tpu_torch import args as port_args
from srvp_tpu_torch import train_main

from test_torch_train_cli import parse

KTH_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "kth.yaml")
# `--device` is the port's torch device ("cuda" or "cpu"); the JAX
# trainer's is a list of ints that it accepts and ignores
DIFFERENT = {"device"}


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(set(_actions(jax_args.create_args())) - DIFFERENT)


def _type_name(t):
    return None if t is None else t.__name__


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_port_has_the_jax_flag(dest):
    jax_a = _actions(jax_args.create_args())[dest]
    port = _actions(port_args.create_args())
    assert dest in port, f"--{dest} is missing from the port's trainer"
    a = port[dest]
    assert a.option_strings == jax_a.option_strings
    assert _type_name(a.type) == _type_name(jax_a.type)
    assert a.default == jax_a.default
    assert a.required == jax_a.required
    assert a.choices == jax_a.choices
    assert (a.nargs, a.const) == (jax_a.nargs, jax_a.const)


def test_device_is_the_torch_device():
    a = _actions(port_args.create_args())["device"]
    assert (a.type, a.default) == (str, "cuda")


def test_config_file_gives_the_jax_namespace(tmp_path):
    argv = ["--config", KTH_YAML, "--data_dir", str(tmp_path / "d"),
            "--save_path", str(tmp_path / "xp")]
    jax_ns = vars(jax_args.create_args().parse_args(argv))
    port_ns = vars(port_args.create_args().parse_args(argv))
    for k in DIFFERENT:
        jax_ns.pop(k)
        port_ns.pop(k)
    assert port_ns.pop("fused_rollout") == "auto"
    assert port_ns == jax_ns
    assert (port_ns["dataset"], port_ns["archi"], port_ns["ny"],
            port_ns["skipco"]) == ("kth", "vgg", 50, True)


def test_command_line_overrides_the_config_file(tmp_path):
    opt = port_args.create_args().parse_args(
        ["--config", KTH_YAML, "--data_dir", "d", "--save_path", "x",
         "--batch_size", "3", "--ny", "4"])
    assert (opt.batch_size, opt.ny, opt.nz) == (3, 4, 50)


def test_keep_chkpt_keeps_the_newest_snapshots(tmp_path):
    assert train_main.main(parse(tmp_path, "--device", "cpu", "--n_iter",
                                 "4", "--val_interval", "4",
                                 "--chkpt_interval", "1",
                                 "--keep_chkpt", "1")) == 0
    kept = sorted(p.name for p in (tmp_path / "xp").glob("model*.pt"))
    assert kept == ["model.pt", "model_4.pt", "model_best.pt"]


def test_keep_chkpt_must_not_be_negative(tmp_path):
    with pytest.raises(SystemExit):
        parse(tmp_path, "--keep_chkpt", "-1")


@pytest.mark.parametrize("flags,precision", [
    ([], "float32"), (["--precision", "bfloat16"], "bfloat16"),
    (["--torch_amp"], "bfloat16"), (["--apex_amp"], "bfloat16"),
    (["--amp_opt_lvl", "O3"], "float32"),
    (["--keep_batchnorm_fp32"], "float32"), (["--apex_verbose"], "float32")])
def test_mixed_precision_flags_select_the_jax_compute_dtype(tmp_path, flags,
                                                           precision):
    """The port maps the mixed-precision flags to the compute dtype that
    the JAX trainer's train_hparams gives them (it reads train.py's
    DotDict), and check_ported accepts them."""
    argv = ["--config", KTH_YAML, "--data_dir", str(tmp_path / "d"),
            "--save_path", str(tmp_path / "xp"), *flags]
    jax_opt = DotDict(vars(jax_args.create_args().parse_args(argv)))
    want = jax_train_main.train_hparams(jax_opt).compute_dtype
    assert want.__name__ == precision
    opt = port_args.create_args().parse_args(argv)
    port_args.check_ported(opt)
    assert port_args.compute_dtype(opt) == getattr(torch, precision)


@pytest.mark.parametrize("flags", [
    ["--local_rank", "1"], ["--n_dcn", "2"],
    ["--coordinator_address", "auto"], ["--num_processes", "2"],
    ["--process_id", "1"], ["--subsampling", "4"]])
def test_jax_flags_of_unported_parts_raise(tmp_path, flags):
    opt = parse(tmp_path, "--device", "cpu", *flags)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main.main(opt)


def test_amp_flags_stay_exclusive(tmp_path):
    with pytest.raises(SystemExit):
        parse(tmp_path, "--torch_amp", "--apex_amp")

