"""Training and closed-loop evaluation of the port."""
