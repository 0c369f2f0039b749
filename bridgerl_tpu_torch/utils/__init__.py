"""Console logging and the retargeting API."""
