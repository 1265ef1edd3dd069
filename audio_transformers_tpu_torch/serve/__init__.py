"""Serving entry point."""
