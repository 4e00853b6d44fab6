"""Synthetic transaction data."""
