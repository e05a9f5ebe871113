"""Ops: plain PyTorch versions and the hand-written CUDA kernel."""
