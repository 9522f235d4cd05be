"""Closed-loop evaluation of the port."""
