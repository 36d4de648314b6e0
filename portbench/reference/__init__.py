"""The plain reference the benchmark checks the port against: plain PyTorch
and numpy, nothing of the port imported."""
