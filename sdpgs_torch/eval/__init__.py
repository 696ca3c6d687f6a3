"""Evaluation metrics."""
