from .synthetic import camera_ring, synthetic_batch, tiny_config

__all__ = ["camera_ring", "synthetic_batch", "tiny_config"]
