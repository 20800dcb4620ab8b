"""Data parallelism over several processes, one a card (counterpart of
srvp_tpu/parallel): `multihost` joins the ranks and keeps their bookkeeping,
`mesh` reduces the gradients and metrics and spawns the local ranks."""
