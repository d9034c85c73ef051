"""The paper's evaluation on the port: one module per figure or table.

``fig1_accuracy`` (Fig. 1), ``table1_configs`` (Table I),
``fig3_system_time`` (Fig. 3) and ``fig4_trends`` (Fig. 4) run KLARAPTOR
over the PolyBench suite (``configs.polybench``); ``run`` runs all four.
Each prints ``name,us_per_call,derived`` lines, every row naming the oracle
that timed it::

    python -m repro_torch.benchmarks.fig1_accuracy [--device cpu]

On the card (the default) the suite's matmul rows that launch the f32 SIMT
matmul are timed by ``CudaEventTimer`` and the other rows by
``HopperModel``; with ``--device cpu`` every row is timed by
``HopperModel``.  Importing a module runs nothing.
"""
