"""Model hyperparameters and device selection."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SRVPConfig:
    """Static model hyperparameters (same fields and defaults as
    srvp_tpu.models.srvp.SRVPConfig)."""
    nx: int = 64          # frame width/height
    nc: int = 1           # channels
    nf: int = 64          # first-conv filters
    nhx: int = 128        # frame encoding size
    ny: int = 20          # state dimension
    nz: int = 20          # auxiliary variable dimension
    skipco: bool = False  # encoder->decoder skip connections
    nt_inf: int = 5       # frames used to infer y_1 / w
    nh_inf: int = 256     # inference MLP hidden size
    nlayers_inf: int = 3  # inference MLP layers
    nh_res: int = 512     # dynamics MLP hidden size
    nlayers_res: int = 4  # dynamics MLP layers
    archi: str = "dcgan"  # 'dcgan' | 'vgg'


def model_config(xp_config):
    """SRVPConfig from an experiment config mapping (config.json)."""
    return SRVPConfig(nx=xp_config["nx"], nc=xp_config["nc"],
                      nf=xp_config["nf"], nhx=xp_config["nhx"],
                      ny=xp_config["ny"], nz=xp_config["nz"],
                      skipco=bool(xp_config["skipco"]),
                      nt_inf=xp_config["nt_inf"], nh_inf=xp_config["nh_inf"],
                      nlayers_inf=xp_config["nlayers_inf"],
                      nh_res=xp_config["nh_res"],
                      nlayers_res=xp_config["nlayers_res"],
                      archi=xp_config["archi"])


def resolve_device(device="cuda"):
    """torch.device for an entry point. Asking for CUDA where there is none
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def strict_fp32():
    """Turns TF32 off for matmuls and cuDNN convs. The JAX reference
    evaluates in float32, and TF32 keeps about three decimal digits, which
    would break float32 parity with it (cuDNN convs default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
