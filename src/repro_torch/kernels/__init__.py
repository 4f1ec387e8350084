"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it (see ``ops`` for the dispatch rule)."""
