"""Fault-tolerance pieces of the port (the embedding slice: heartbeats)."""
