"""Data: sources, the host pipeline and its staging onto the device, and
the on-device preprocessing."""
