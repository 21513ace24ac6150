"""Launchers of the port: the rightsizing CLI (``launch.rightsize``), the
LM serving driver (``launch.serve``) and the model presets it uses
(``launch.train``)."""
