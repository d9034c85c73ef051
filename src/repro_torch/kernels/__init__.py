"""The port's kernels: hand-written CUDA for Hopper, built at first use.

``matmul`` holds the tiled matmul's wrapper, launch counter and plain
PyTorch version; ``ops`` the tuned dispatch that ``choose_or_default`` feeds.
Importing these modules builds nothing: the CUDA source compiles on the
first launch (``_build``).
"""
