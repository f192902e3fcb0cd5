"""Evaluation tools (the port's ``scripts/evaluation/``):
``compute_wer_and_accent_metrics`` and ``compare_pitch_curves``."""
