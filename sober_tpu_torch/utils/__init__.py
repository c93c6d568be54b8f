"""Numerics helpers of the port."""
