"""Decoding and evaluation."""
