"""Testing aids of the port: deterministic fault injection (``chaos``)."""
