"""The host pipelines of the nuScenes and SemanticKITTI loaders: numpy
copies of coocc_tpu/data/pipelines/. PIL is imported inside the functions
that decode or transform pixels (image_loading.py, loading_bevdet.py), so
the LiDAR-only configs' data path never imports it."""
