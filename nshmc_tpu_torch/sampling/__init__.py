"""nshmc_tpu_torch.sampling"""
