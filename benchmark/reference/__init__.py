"""The plain PyTorch reference that decides ``correct``."""
