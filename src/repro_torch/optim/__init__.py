"""The optimizer (AdamW) as plain functions on tensor trees."""
