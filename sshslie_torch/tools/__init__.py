"""Measurement scripts of the port that are not part of its path."""
