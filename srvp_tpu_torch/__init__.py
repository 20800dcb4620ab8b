"""srvp_tpu_torch — the PyTorch/CUDA port of srvp_tpu for NVIDIA Hopper.

The port keeps the JAX package's public layouts (videos time-major and
channels-last, (T, B, H, W, C)) and its parameter names: a model's
state_dict uses the reference checkpoint key names, so JAX checkpoints load
through `utils.weights` and reference `.pt` state_dicts load as they are.
Convolutions run NCHW inside the modules. The one hand-written kernel of the
generation path, the pure-prior latent rollout, lives in `csrc/rollout.cu`
and is built with nvcc on first use (`kernels.build`).

This package imports torch, numpy and the standard library only; it never
imports jax or srvp_tpu.
"""
