"""On-device paired dataset."""
