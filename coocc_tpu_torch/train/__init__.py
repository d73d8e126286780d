"""Training: the optimizer (state.py) and the synthetic-data step loop
(`python -m coocc_tpu_torch.train`, __main__.py). The step itself is
parallel/train_step.py."""
