"""Utilities: the Flax weight bridge."""
