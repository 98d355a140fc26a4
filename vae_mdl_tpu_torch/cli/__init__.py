"""The command line (``cli/run.py``)."""
