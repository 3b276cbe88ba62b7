# Hand-written CUDA kernels for the paper's hot spots (sources in ../csrc),
# each with a plain PyTorch twin in ref.py and a wrapper in ops.py.
