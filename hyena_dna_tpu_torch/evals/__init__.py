"""Evaluation entry points of the port."""
