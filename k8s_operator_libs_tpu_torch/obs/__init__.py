"""Observability: the minimal span tracer of the drain handshake."""
