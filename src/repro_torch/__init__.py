"""KLARAPTOR on PyTorch and CUDA for an NVIDIA H100.

The port of the JAX package ``repro`` (which stays the reference), with the
same layout: ``core`` (rational programs, fitting, the Hopper device model
and performance model, generated drivers, the tuner), ``search`` (probe
selection under a budget), ``kernels`` (hand-written CUDA kernels, their
plain PyTorch versions, and the tuned ops), ``models`` and ``configs`` (the
dense decoder LM, llama3.2-1b), ``launch`` (the prefill step, the engine
builder) and ``serving`` (the continuous-batching engine).  It imports
neither ``jax`` nor ``repro``.
"""
