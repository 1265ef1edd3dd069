"""Training: optimizer and schedules, the whisper-emotion trainer."""
