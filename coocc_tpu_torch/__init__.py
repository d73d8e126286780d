"""coocc_tpu_torch: the PyTorch / CUDA port of coocc_tpu for NVIDIA Hopper.

A second package beside the JAX reference `coocc_tpu`; it imports torch and
numpy and nothing of JAX or of coocc_tpu. The layout mirrors the reference
(config/, data/, geometry/, ops/, nn/, models/), one path per op. This slice
ports the eval forward of the flagship config coocc_multi_r50_256x704 in
fp32; `entry.entry()` builds it, `convert.state_dict_from_jax` carries JAX
weights across, and the one TPU kernel on that path, the window-KNN best-2
search, is the CUDA kernel csrc/window_knn.cu (ops/window_knn.py).
"""
__version__ = "0.1.0"
