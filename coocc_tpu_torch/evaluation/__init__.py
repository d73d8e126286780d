"""Evaluation: the SSC/SC and lidarseg confusion matrices and their
summary (ssc_metrics.py), the result tables (formatting.py), the
prediction dumps and the SemanticKITTI label writer (savers.py), and the
rendered views' PSNR and SSIM (render_metrics.py)."""
