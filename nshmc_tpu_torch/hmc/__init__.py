"""nshmc_tpu_torch.hmc"""
