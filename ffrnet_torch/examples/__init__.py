"""Runnable quickstarts of the port (counterparts of examples/)."""
