"""nshmc_tpu_torch.solvers: DMPlug (solvers/dmplug.py), schedule-free AdamW
(solvers/sf_adamw.py) and optax's Adam and AdamW written out (solvers/adamw.py)."""
