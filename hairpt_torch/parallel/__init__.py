"""Rendering and the inverse step across GPUs (mesh.py)."""
