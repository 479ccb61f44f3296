"""Inference helpers, transform math and CLI parsing."""
