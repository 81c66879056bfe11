"""Helpers of the copied host codec (`debug.py`)."""
