from .chains import acceptance_stats, chain_mesh, make_sharded_hmc, make_sharded_latent_hmc
