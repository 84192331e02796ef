"""Distributed pieces of the port: so far the plain flash-decoding partials."""
