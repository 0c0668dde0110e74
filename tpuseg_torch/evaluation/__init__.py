"""Eval forward, device-side metrics and IoU tables."""
