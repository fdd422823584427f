"""Serving over HTTP, and `torch.export` of a detector with its runner."""
