from .coocc_ray import STAGES, Batch, CoOccRay

__all__ = ["STAGES", "Batch", "CoOccRay"]
