"""Evaluation CLI (`python -m coocc_tpu_torch.test`, __main__.py)."""
