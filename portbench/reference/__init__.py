"""Plain references of the cells' answers: PyTorch and Python only,
importing nothing of the program under test."""
