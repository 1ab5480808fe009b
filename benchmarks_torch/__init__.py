"""The paper's experiments (Table II, Figs. 1/4/5/6) and the kernel, sparsity,
search and DSE gates, on the PyTorch/CUDA port (``repro_torch``): one module
per script of ``benchmarks/``, with the same ``run()`` arguments and
defaults, plus ``device`` (the card unless the caller asks for ``"cpu"``) and
``out_dir``. ``python -m benchmarks_torch.run`` runs them all."""
