"""Drivers of the traffic kinds, each named by a mix file's ``driver``."""
