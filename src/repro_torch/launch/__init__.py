"""Launchers of the port: the rightsizing CLI (``launch.rightsize``)."""
