"""Fault tolerance beyond cell replication: fail-stop recovery."""
