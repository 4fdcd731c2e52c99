"""nshmc_tpu_torch.models"""
