"""PyTorch/CUDA port of the printed-MLP GA trainer (``repro``). Importing
the package builds and loads nothing: the CUDA kernels build on their
first launch (``repro_torch.kernels._cuda``)."""
