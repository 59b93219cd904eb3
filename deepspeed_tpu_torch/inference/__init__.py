"""Inference engines of the port."""
