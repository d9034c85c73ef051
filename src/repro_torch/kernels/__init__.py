"""The port's kernels: hand-written CUDA for Hopper, built at first use.

``matmul``, ``flash_attention``, ``ssd_scan``, ``moe_gmm``, ``layernorm`` and
``reduce`` (the column sum) hold each kernel's wrapper, launch counter and
plain PyTorch version; ``ops`` the tuned dispatch that ``choose_or_default``
feeds.  Importing these modules builds nothing: a CUDA
source compiles on its kernel's first launch (``_build``).
"""
