"""Operators of the port: prefix splice, attention core, decoding."""
