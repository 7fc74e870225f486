"""Device ops of the port: synthesis products, deemphasis and the comb
postfilter (plain PyTorch versions beside the CUDA kernel)."""
