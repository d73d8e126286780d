"""Evaluation: the SSC/SC and lidarseg confusion matrices and their
summary (ssc_metrics.py), the result tables (formatting.py) and the
prediction dumps (savers.py)."""
