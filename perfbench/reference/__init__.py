"""Plain PyTorch and NumPy references that decide ``correct``. They
import nothing of the program under test."""
