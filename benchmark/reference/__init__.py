"""Plain PyTorch references of the benchmark's models (float32, no kernel of
the measured program, no cache, no remat). They import nothing of the
program: they are frozen copies of the published architectures, built with
the same parameter names as the reference checkpoints, so one state_dict
loads into the program and into them with `load_state_dict(strict=True)`."""
