"""Utilities of the port: environment readers (``envs``) and the step
metrics bus (``metrics_bus``)."""
