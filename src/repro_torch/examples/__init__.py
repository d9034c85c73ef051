"""Runnable examples of the port: ``quickstart`` (KLARAPTOR end to end on
the bf16 matmul) and ``polybench_suite`` (the paper's evaluation over the
suite).  Run each with ``python -m repro_torch.examples.<name>``; importing
a module runs nothing.
"""
