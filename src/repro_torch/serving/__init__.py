"""Rulebook compile and batched recommend."""
