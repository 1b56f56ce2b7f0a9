"""Serving engines over the port's models."""
