from .base import (
    CoOccConfig, DataConfig, FuserConfig, GridConfig, ImageBackboneConfig,
    ImageNeckConfig, LSSConfig, OccHeadConfig, OptimConfig, PtsBranchConfig,
    RenderConfig, SECOND3DConfig, SemanticEncoderConfig, frustum_feat_size,
)
from .configs import get_config, list_configs

__all__ = [
    "CoOccConfig", "DataConfig", "FuserConfig", "GridConfig",
    "ImageBackboneConfig", "ImageNeckConfig", "LSSConfig", "OccHeadConfig",
    "OptimConfig", "PtsBranchConfig", "RenderConfig", "SECOND3DConfig",
    "SemanticEncoderConfig", "frustum_feat_size", "get_config", "list_configs",
]
