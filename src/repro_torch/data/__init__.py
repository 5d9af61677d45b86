"""The data source cell (deterministic batches on the device)."""
