"""Launchers of the port: the LM training launcher (``launch.train``)."""
