"""Measurement scripts of the port, run as `python -m nshmc_tpu_torch.scripts.<name>`."""
