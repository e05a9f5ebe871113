"""The plain PyTorch reference that decides `correct`: frozen, and
independent of the program under test."""
