"""nshmc_tpu_torch.solvers: DMPlug (solvers/dmplug.py)."""
