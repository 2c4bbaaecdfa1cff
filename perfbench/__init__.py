"""The benchmark of the PyTorch and CUDA codec package (dct_tpu_torch):
run one cell with ``python perfbench/run.py``."""
