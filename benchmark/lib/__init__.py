"""The harness's yardstick: cells, inputs, counts, the trace and the checks."""
