"""nshmc_tpu_torch.utils"""
