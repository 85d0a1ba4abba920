"""The plain reference of the comparison that decides ``correct``: NumPy
and plain PyTorch in float32, nothing of the program."""
