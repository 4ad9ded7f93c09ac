"""The plain references: plain PyTorch and NumPy that import nothing of the
program, and the comparison that decides a run's ``correct``."""
