"""Rendering, metrics and the weight file of the port."""
