"""Serving of the port."""
