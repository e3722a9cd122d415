"""Host-side utilities of the port: the evaluation metrics and the yml
configuration."""
