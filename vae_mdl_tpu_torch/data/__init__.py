"""Data handling; so far only the on-device preprocessing of a train step."""
