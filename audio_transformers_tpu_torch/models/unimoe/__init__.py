"""Uni-MoE-2.0-Omni: the whisper encoder into a dynamic-capacity MoE language model."""
