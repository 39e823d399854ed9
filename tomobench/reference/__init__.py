"""The plain reference of the benchmark's cells: plain PyTorch and numpy,
independent of the measured package (it imports nothing of it), given the
same inputs as the program and deriving everything else itself."""
