"""Checkpoint helpers of the port: the atomic write the handoff spool
uses (``atomic``)."""
