"""coocc_tpu_torch: the PyTorch / CUDA port of coocc_tpu for NVIDIA Hopper.

A second package beside the JAX reference `coocc_tpu`; it imports torch and
numpy and nothing of JAX or of coocc_tpu. The layout mirrors the reference
(config/, data/, geometry/, ops/, nn/, models/), one path per op. It ports
the eval forward of the flagship config coocc_multi_r50_256x704 in fp32;
`entry.entry()` builds it and `convert.state_dict_from_jax` carries JAX
weights across. Each TPU kernel of the reference is a CUDA kernel in csrc/
with its wrapper and plain version in ops/: the window-KNN best-2 search
(window_knn.cu, twice per forward in the fuser), the packed SubM
convolution (subm_conv.cuh, 13 times per forward in the z-packed LiDAR
encoder, 16 in coocc_lidar's HD encoder) and the exact 2-NN search
(knn.cu, no caller on the path).
"""
__version__ = "0.1.0"
