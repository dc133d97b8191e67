"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off, written from the published equations; it imports nothing of the
program under test."""
