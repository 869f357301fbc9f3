"""The harness: manifest, inputs, traffic, the measured window, the trace
reduction and the output check."""
