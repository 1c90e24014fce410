"""Data ingestion (ULTRA format) and TREC ranklist output."""
