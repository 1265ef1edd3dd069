"""Inference pipeline."""
