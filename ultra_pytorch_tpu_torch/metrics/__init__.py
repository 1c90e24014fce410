"""Listwise ranking metrics."""
