"""Whisper encoder-decoder, greedy decode and emotion head."""
