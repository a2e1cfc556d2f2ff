"""Utilities of the trainer."""
