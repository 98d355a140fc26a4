"""Runnable examples: a custom model family, and train -> export -> serve."""
