"""The benchmark of the PyTorch/CUDA port (`wtw_tpu_torch`): one training
cell a run, on the H100. See README.md."""
