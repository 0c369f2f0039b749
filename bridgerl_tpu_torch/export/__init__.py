"""Serving surface of the port: in-process serving functions, the HTTP host
and its client, and long-sequence overlap-add."""
