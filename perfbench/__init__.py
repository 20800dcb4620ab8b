"""The benchmark of the H100 port (srvp_tpu_torch): python -m perfbench.run."""
