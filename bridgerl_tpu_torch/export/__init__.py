"""Serving surface of the port: the serving functions, live or frozen into an
artifact of ``torch.export`` programs, the HTTP host and its client,
long-sequence and streaming overlap-add, and motion export."""
