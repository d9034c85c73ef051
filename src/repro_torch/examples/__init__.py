"""Runnable examples of the port: ``quickstart`` (KLARAPTOR end to end on
the bf16 matmul), ``polybench_suite`` (the paper's evaluation over the
suite), ``train_lm`` (a llama-family model trained end to end) and
``serve_lm`` (requests through the continuous-batching engine).  Run
each with ``python -m repro_torch.examples.<name>``; importing a module runs
nothing.
"""
