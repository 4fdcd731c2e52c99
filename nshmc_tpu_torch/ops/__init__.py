"""nshmc_tpu_torch.ops"""
