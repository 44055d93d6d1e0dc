"""Evaluation steps (training arrives with a later slice)."""
