"""Device ops of the port: the PVQ value-plane replay with its spreading
rotation, synthesis products, the comb postfilter and deemphasis (plain
PyTorch versions beside the CUDA kernels)."""
