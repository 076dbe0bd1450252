"""Fleet utilities of the port (counterpart of
``paddle_tpu/distributed/fleet``)."""
