"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

BF16_FLOP_PER_S = 989e12     # bf16 / fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # HBM3
TRAIN_STEP_FORWARDS = 3      # a train step counts as three forwards
