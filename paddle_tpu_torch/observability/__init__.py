"""Training telemetry of the port: the metrics registry (``metrics``) and
the training-dynamics monitor (``dynamics``)."""
